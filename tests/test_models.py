"""Scene model tests: instancing, registries, resolutions."""

import numpy as np
import pytest

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.geometry import make_sphere
from rust_raytrace_tpu.materials import matte, solid
from rust_raytrace_tpu.models import REGISTRY, circles, multi
from rust_raytrace_tpu.models.multi import instance

F32 = np.float32

IDENT = (m3.vec(1, 0, 0), m3.vec(0, 1, 0), m3.vec(0, 0, 1))


def test_registry_contents():
    assert set(REGISTRY) == {"teapot", "circles", "multi", "obj",
                             "sphere_100k", "sphere_1m"}


def test_instance_transform_semantics():
    """instance() applies the OBJ loader's v*scale -> basis -> +offset
    (obj_parser.rs:64-66) to an existing table and re-precomputes."""
    base = make_sphere((0.0, 0.0, 0.0), 1.0, (4, 6),
                       solid(m3.make_color((10, 20, 30))), 0.0)
    inst = instance(base, offset=(5.0, 0.0, 0.0), scale=2.0, transform=IDENT,
                    surface=matte(m3.make_color((1, 2, 3)), 0.5),
                    edge_thickness=0.1)
    assert len(inst) == len(base)
    np.testing.assert_allclose(inst.corners, base.corners * 2.0
                               + np.asarray([5.0, 0, 0], dtype=F32),
                               rtol=1e-5)
    # precompute is consistent with the transformed corners
    np.testing.assert_allclose(inst.incenter, base.incenter * 2.0
                               + np.asarray([5.0, 0, 0], dtype=F32),
                               rtol=1e-5, atol=1e-5)
    assert (inst.materials.alpha == F32(0.5)).all()


def test_circles_scene_builds():
    scene, vp = circles.build(resolution=(16, 16), maxdepth=2)
    assert scene.num_triangles > 500
    # renders without error and hits something
    img = oracle.render(scene.tris, vp, rng=oracle.FixedRng())
    sky = m3.make_color((128, 180, 255))
    assert not np.allclose(img, sky)


def test_multi_scene_has_instances(monkeypatch, tmp_path):
    import os

    from rust_raytrace_tpu.obj_parser import parse_obj
    path = os.path.join(os.path.dirname(__file__), "assets", "two_mats.obj")
    one = tmp_path / "one.obj"
    one.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    scene, vp = multi.build(resolution=(8, 8), maxdepth=2, obj_path=path)
    small, _ = multi.build(resolution=(8, 8), maxdepth=2, obj_path=str(one))
    template = parse_obj(path, offset=(0.0, 0.0, 0.0), scale=1.0,
                         transform=np.eye(3, dtype=F32),
                         surface=matte(m3.make_color((1, 1, 1)), 0.2),
                         edge_thickness=0.0)
    # spheres + disk, plus three instances of the template mesh
    assert small.num_triangles > 700
    assert scene.num_triangles - small.num_triangles == \
        3 * (len(template) - 1)
    # without the template mesh, multi is not silently a smaller scene
    monkeypatch.setattr("rust_raytrace_tpu.scene.REFERENCE_DIR",
                        "/nonexistent")
    with pytest.raises(FileNotFoundError):
        multi.build(resolution=(8, 8), maxdepth=2)


def test_obj_scene_auto_framing(tmp_path):
    """Generic user-OBJ scene: mesh loads with MTL, camera auto-frames it
    (the mesh is visible and fills a sane fraction of the image)."""
    import os

    from rust_raytrace_tpu.models import objfile

    asset = os.path.join(os.path.dirname(__file__), "assets", "two_mats.obj")
    scene, vp = objfile.build(resolution=(32, 32), maxdepth=2, obj_path=asset)
    assert scene.num_triangles == 3   # 2 faces + the miss sentinel
    img = oracle.render(scene.tris, vp, rng=oracle.FixedRng())
    sky = m3.make_color((128, 180, 255))
    non_sky = (~np.all(np.isclose(img, sky), axis=-1)).mean()
    assert 0.02 < non_sky < 0.9          # visible, not wall-filling

    # MTL honored: the red_matte face tints some pixels red-dominant
    reds = img[..., 0] > img[..., 2] + 0.1
    assert reds.any()

    # deterministic framing
    _, vp2 = objfile.build(resolution=(32, 32), maxdepth=2, obj_path=asset)
    np.testing.assert_array_equal(vp.orig, vp2.orig)


def test_obj_scene_requires_path_and_faces(tmp_path):
    from rust_raytrace_tpu.models import objfile

    with pytest.raises(ValueError, match="--obj"):
        objfile.build(resolution=(8, 8))
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="no faces"):
        objfile.build(resolution=(8, 8), obj_path=str(empty))


def test_cli_obj_scene(tmp_path):
    import os

    from rust_raytrace_tpu.cli import main
    from rust_raytrace_tpu.utils.png import read_png

    asset = os.path.join(os.path.dirname(__file__), "assets", "two_mats.obj")
    out = str(tmp_path / "o.png")
    rc = main(["render", "--scene", "obj", "--obj", asset,
               "--resolution", "16x16", "--backend", "oracle",
               "--maxdepth", "2", "--out", out])
    assert rc == 0
    assert read_png(out).shape == (16, 16, 3)

    with pytest.raises(SystemExit, match="--obj"):
        main(["render", "--scene", "obj", "--resolution", "16x16",
              "--backend", "oracle", "--out", out])
