"""Randomized-scene differential contract (seeded, deterministic).

The reference validates its CUDA path by differencing whole renders against
the CPU implementation (debug.rs:150-222) — but only on its three hand-built
scenes.  This file generalizes that methodology to RANDOM geometry: seeded
random scenes (triangle soup + lat/lon spheres + thick disks, mixed
solid/matte/reflective materials, random camera pose) rendered by all three
implementations, asserting the same contract test_bitexact.py pins on the
curated scenes:

  - production Engine (trace kernel in interpret mode, and its plain-XLA
    traversal; both compacted) == WavefrontRenderer("xla") to the BIT, and
  - both within 1 ULP (2^-23) of the recursive numpy oracle (same color
    polynomial, different association order).

Random scenes reach structure the curated scenes cannot: degenerate-thin
triangles, overlapping unaligned AABBs, SAH splits over irregular centroid
distributions, and a page count past MAX_BANKS that makes the kernel walk
banks of several pages.
"""

import numpy as np
import pytest

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine
from rust_raytrace_tpu.geometry import make_disk, make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.render import WavefrontRenderer
from rust_raytrace_tpu.scene import assemble

ULP = 1.1920929e-07  # 2**-23
F32 = np.float32


def _rand_surface(rng):
    color = m3.make_color(tuple(int(c) for c in rng.integers(10, 255, 3)))
    kind = rng.integers(0, 3)
    if kind == 0:
        return solid(color)
    if kind == 1:
        return matte(color, float(rng.uniform(0.05, 0.6)))
    return reflective(color, float(rng.uniform(0.1, 0.7)),
                      float(rng.uniform(0.0, 0.25)))


def _soup(rng, n, center, spread):
    """n random free triangles around `center`."""
    c = np.asarray(center, dtype=F32)
    pts = rng.uniform(-spread, spread, (n, 3, 3)).astype(F32)
    anchors = rng.uniform(-2.5, 2.5, (n, 1, 3)).astype(F32)
    pts = pts * F32(0.35) + anchors + c
    return make_triangles(pts, _rand_surface(rng),
                          float(rng.uniform(0.0, 0.1)))


def _rand_scene(rng, n_soup=3, spheres=(), disks=()):
    parts = [_soup(rng, int(rng.integers(4, 14)), (0.0, 0.0, 8.0), 1.0)
             for _ in range(n_soup)]
    for latlon in spheres:
        orig = rng.uniform(-2, 2, 3).astype(F32) + np.asarray(
            [0, 0, 8], dtype=F32)
        parts.append(make_sphere(tuple(orig), float(rng.uniform(0.8, 2.0)),
                                 latlon, _rand_surface(rng),
                                 float(rng.uniform(0.0, 0.08))))
    for num_tris in disks:
        orig = rng.uniform(-2, 2, 3).astype(F32) + np.asarray(
            [0, 0, 8], dtype=F32)
        norm = m3.unit(rng.uniform(-1, 1, 3).astype(F32))
        parts.append(make_disk(tuple(orig), norm, float(rng.uniform(0.7, 1.5)),
                               float(rng.uniform(0.05, 0.3)), num_tris,
                               _rand_surface(rng), _rand_surface(rng),
                               float(rng.uniform(0.0, 0.08))))
    return assemble(parts)


def _rand_viewport(rng, px, maxdepth):
    # jittered pose looking roughly at the +z cluster the scenes sit in
    pos = rng.uniform(-0.4, 0.4, 3).astype(F32)
    aim = m3.unit(np.asarray(
        [rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25), 1.0],
        dtype=F32))
    return create_viewport(px, (1.5, 1.5 * px[1] / px[0]), pos, aim,
                           float(rng.uniform(60.0, 100.0)),
                           float(rng.uniform(-0.3, 0.3)), maxdepth, 1)


def _assert_contract(scene, vp, page_size, ray_chunk, bank_pages=1):
    img_o = oracle.render(scene.tris, vp, rng=oracle.FixedRng())

    wr = WavefrontRenderer(scene, page_size=page_size)
    img_x = wr.render(vp, fixed_rng=True).image

    for trace in ("kernel", "xla"):
        eng = Engine(scene, page_size=page_size, ray_chunk=ray_chunk,
                     interpret=True, trace=trace)
        assert eng.compact
        assert eng.tables.bank_pages >= bank_pages
        img_e = eng.render(vp, fixed_rng=True, quantize=False).image
        np.testing.assert_array_equal(img_e, img_x)
    assert np.abs(img_e - img_o).max() <= ULP
    assert np.abs(img_x - img_o).max() <= ULP


@pytest.mark.parametrize("seed", [11, 23])
def test_random_soup_scene(seed):
    rng = np.random.default_rng(seed)
    scene = _rand_scene(rng, n_soup=4)
    vp = _rand_viewport(rng, (32, 24), maxdepth=4)
    _assert_contract(scene, vp, page_size=16, ray_chunk=128)


def test_random_mixed_scene():
    rng = np.random.default_rng(47)
    scene = _rand_scene(rng, n_soup=2, spheres=[(6, 8)], disks=[5])
    vp = _rand_viewport(rng, (32, 24), maxdepth=4)
    _assert_contract(scene, vp, page_size=24, ray_chunk=128)


def test_random_lights_scene():
    """Lights fuzz: random scene + random jittered light.  The compacted
    engine must match the compact=False engine BITWISE, and the oracle up to
    flipped shadow-boundary pixels (occlusion is a binary decision: f32
    rounding may flip tangent pixels — same criterion as test_shadows.py)."""
    from rust_raytrace_tpu.scene import LightSource

    rng = np.random.default_rng(59)
    scene = _rand_scene(rng, n_soup=3, disks=[4])
    scene.lights = LightSource(
        orig=rng.uniform(-4, 4, 3).astype(F32) * np.asarray(
            [1, 1, 0], dtype=F32) + np.asarray([0, 16, 8], dtype=F32),
        len2=float(rng.uniform(0.0, 0.6)))
    vp = _rand_viewport(rng, (32, 24), maxdepth=3)

    img_o = oracle.render(scene.tris, vp, rng=oracle.FixedRng(),
                          lights=scene.lights)
    e1 = Engine(scene, page_size=16, ray_chunk=128, interpret=True,
                compact=True)
    e0 = Engine(scene, page_size=16, ray_chunk=128, interpret=True,
                compact=False)
    i1 = e1.render(vp, fixed_rng=True, quantize=False).image
    i0 = e0.render(vp, fixed_rng=True, quantize=False).image
    np.testing.assert_array_equal(i1, i0)
    diff = np.abs(i1 - img_o).max(axis=-1)
    assert (diff > 1 / 255).mean() < 0.01


def test_random_multibank_scene():
    """More pages than MAX_BANKS at P=4: the kernel walks banks of several
    pages on random geometry (the curated scenes reach that only at full
    scale, where interpret mode is impractical)."""
    rng = np.random.default_rng(101)
    scene = _rand_scene(rng, n_soup=2, spheres=[(22, 26)])
    vp = _rand_viewport(rng, (24, 16), maxdepth=3)
    _assert_contract(scene, vp, page_size=4, ray_chunk=128, bank_pages=2)


# --- soak contracts, pinned at fixed seeds (45 disjoint seeds 700-744 were
# run through these; one representative seed per contract is committed) ---


@pytest.mark.parametrize("seed", [702, 741])
def test_random_spp_compact_equals_legacy(seed):
    """Random scene at spp>1: compacted pipeline (samples are adjacent
    rays, on-device box filter) == uncompacted pipeline BITWISE, on both
    the float and the quantized framebuffers.  Seed 741 once caught one
    pixel whose box-filtered mean lands exactly on a u8 quantization
    boundary, exposing XLA reduce-association divergence between two
    programs (fixed by _box_filter's explicit add chain)."""
    rng = np.random.default_rng(seed)
    scene = _rand_scene(rng, n_soup=int(rng.integers(2, 4)),
                        disks=[int(rng.integers(3, 8))] if seed % 2 else [])
    samples = int(rng.choice([2, 4]))
    px = (24, 16)
    pos = rng.uniform(-0.4, 0.4, 3).astype(F32)
    aim = m3.unit(np.asarray(
        [rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25), 1.0],
        dtype=F32))
    vp = create_viewport(px, (1.5, 1.5 * px[1] / px[0]), pos, aim,
                         float(rng.uniform(60.0, 100.0)),
                         float(rng.uniform(-0.3, 0.3)),
                         int(rng.integers(3, 5)), samples)
    ps = int(rng.choice([16, 24, 40]))
    e1 = Engine(scene, page_size=ps, ray_chunk=128, interpret=True,
                compact=True)
    e0 = Engine(scene, page_size=ps, ray_chunk=128, interpret=True,
                compact=False)
    np.testing.assert_array_equal(
        e1.render(vp, fixed_rng=True, quantize=False).image,
        e0.render(vp, fixed_rng=True, quantize=False).image)
    np.testing.assert_array_equal(
        e1.render(vp, fixed_rng=True, quantize=True).image,
        e0.render(vp, fixed_rng=True, quantize=True).image)


def test_random_sharded_schedule_bitexact():
    """Random scene on the 8-virtual-device mesh: sharded production engine
    == unsharded BITWISE (image AND wave counts), with compaction on in one
    and off in the other — generalizes
    test_sharding.test_engine_sharded_bitexact to random geometry."""
    from rust_raytrace_tpu.parallel.sharding import make_mesh

    seed = 700
    rng = np.random.default_rng(seed)
    scene = _rand_scene(rng, n_soup=int(rng.integers(2, 4)),
                        spheres=[(6, 8)] if seed % 2 else [])
    vp = _rand_viewport(rng, (32, 24), maxdepth=3)
    ps = int(rng.choice([16, 24]))
    compact = bool(rng.integers(0, 2))
    eng = Engine(scene, page_size=ps, ray_chunk=128, interpret=True,
                 compact=compact)
    ref = Engine(scene, page_size=ps, ray_chunk=128, interpret=True,
                 compact=not compact)
    r1 = ref.render(vp, fixed_rng=True)
    r8 = eng.render_sharded(vp, mesh=make_mesh(8), fixed_rng=True)
    np.testing.assert_array_equal(r8.image, r1.image)
    np.testing.assert_array_equal(r8.wave_rays, r1.wave_rays)


def test_random_obj_roundtrip(tmp_path):
    """Random mesh round-tripped through an .obj/.mtl ON DISK and the
    generic user-OBJ scene builder: parsed corners equal the written
    vertices BITWISE (f32 %.9g text round-trip), then the parsed scene
    passes the full engine == xla == oracle differential contract."""
    from rust_raytrace_tpu.models import objfile

    seed = 701
    rng = np.random.default_rng(seed)
    n_tris = int(rng.integers(6, 30))
    verts = (rng.uniform(-2, 2, (3 * n_tris, 3)).astype(F32)
             + np.asarray([0, 0, 8], dtype=F32))
    mtl_name = f"mesh_{seed}.mtl"
    (tmp_path / mtl_name).write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nNs 10\n"
        "newmtl mirror\nKd 0.9 0.9 0.9\nKs 1.0 1.0 1.0\nNs 900\n")
    obj_path = tmp_path / f"mesh_{seed}.obj"
    with open(obj_path, "w") as f:
        f.write(f"mtllib {mtl_name}\n")
        for v in verts:
            f.write("v %.9g %.9g %.9g\n" % tuple(float(x) for x in v))
        for i in range(n_tris):
            f.write("usemtl %s\n" % ("red" if i % 2 else "mirror"))
            f.write("f %d %d %d\n" % (3 * i + 1, 3 * i + 2, 3 * i + 3))

    scene, vp = objfile.build(resolution=(24, 16), maxdepth=3,
                              obj_path=str(obj_path))
    assert scene.num_triangles == n_tris + 1  # + miss sentinel
    np.testing.assert_array_equal(
        scene.tris.corners[1:].reshape(-1, 3), verts)
    _assert_contract(scene, vp, page_size=16, ray_chunk=128)
