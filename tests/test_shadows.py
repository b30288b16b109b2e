"""Shadow-ray extension tests (commented reference design,
raytrace.rs:600-610, 1203-1224; BASELINE config 3)."""

import numpy as np
import pytest


from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine
from rust_raytrace_tpu.geometry import make_triangles
from rust_raytrace_tpu.materials import solid
from rust_raytrace_tpu.scene import LightSource, assemble

F32 = np.float32


@pytest.fixture(scope="module")
def shadow_scene():
    """Floor + a small occluder between the floor's center and the light."""
    floor = make_triangles(
        np.asarray([[[-10, -2, -5], [10, -2, -5], [0, -2, 25]]], dtype=F32),
        solid(m3.make_color((200, 200, 200))), 0.0)
    # occluder directly above the floor around (0, 0, 6); light far above
    occ = make_triangles(
        np.asarray([[[-1.5, 0.5, 4.5], [1.5, 0.5, 4.5], [0, 0.5, 7.5]]],
                   dtype=F32),
        solid(m3.make_color((250, 50, 50))), 0.0)
    scene = assemble([floor, occ])
    scene.lights = LightSource(orig=np.asarray([0.0, 20.0, 6.0], dtype=F32),
                               len2=0.0)
    return scene


@pytest.fixture(scope="module")
def vp():
    return create_viewport((32, 32), (1.0, 1.0), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, -0.3, 1.0)), 90.0, 0.0, 2, 1)


def test_oracle_shadowing(shadow_scene, vp):
    img_lit = oracle.render(shadow_scene.tris, vp, rng=oracle.FixedRng())
    img_sh = oracle.render(shadow_scene.tris, vp, rng=oracle.FixedRng(),
                           lights=shadow_scene.lights)
    # some floor pixels must turn black under the occluder...
    newly_black = ((img_sh.max(axis=-1) < 1e-6)
                   & (img_lit.max(axis=-1) > 0.5))
    assert newly_black.any()
    # ...but not all floor pixels
    still_lit = (img_sh.max(axis=-1) > 0.5) & (img_lit.max(axis=-1) > 0.5)
    assert still_lit.any()


def test_engine_matches_oracle_with_shadows(shadow_scene, vp):
    img_o = oracle.render(shadow_scene.tris, vp, rng=oracle.FixedRng(),
                          lights=shadow_scene.lights)
    eng = Engine(shadow_scene, page_size=64, ray_chunk=256, interpret=True)
    res = eng.render(vp, fixed_rng=True, quantize=False)
    diff = np.abs(res.image - img_o).max(axis=-1)
    assert (diff > 1 / 255).mean() < 0.01


def test_walk_one_ray_lights_parity(shadow_scene, vp):
    """The single-pixel probe carries the scene's LIGHTS (shadow feelers);
    a probe that rendered the unlit scene would diverge from render()
    exactly where the differ probe is most wanted.  Under fixed_rng the
    probed pixel == render()'s bitwise: a shadowed pixel and a lit pixel
    both."""
    eng = Engine(shadow_scene, page_size=64, ray_chunk=256, interpret=True)
    full = eng.render(vp, fixed_rng=True, debug=True, quantize=False)
    # a pixel blacked by the occluder and a lit floor pixel
    shadowed_px = lit_px = None
    for r in range(vp.height):
        for c in range(vp.width):
            if full.primary_id[r, c] == 0:
                continue
            if full.image[r, c].max() < 1e-6 and shadowed_px is None:
                shadowed_px = (r, c)
            elif full.image[r, c].max() > 0.5 and lit_px is None:
                lit_px = (r, c)
    assert shadowed_px is not None and lit_px is not None
    for px in (shadowed_px, lit_px):
        res = eng.walk_one_ray(vp, px)
        assert res.primary_id[0, 0] == full.primary_id[px]
        np.testing.assert_array_equal(res.image[0, 0], full.image[px])


def test_render_banded_with_lights_bitexact(shadow_scene):
    """Banded rendering carries the lights path (fused shadow feelers)
    through unchanged: banded == full render bitwise under fixed_rng."""
    vp2 = create_viewport((32, 64), (1.0, 2.0), (0.0, 0.0, 0.0),
                          m3.unit(m3.vec(0.0, -0.3, 1.0)), 90.0, 0.0, 2, 1)
    eng = Engine(shadow_scene, page_size=64, ray_chunk=128, interpret=True)
    full = eng.render(vp2, fixed_rng=True)
    banded = eng.render_banded(vp2, fixed_rng=True, band_rows=32)  # 2 bands
    np.testing.assert_array_equal(banded.image, full.image)
    np.testing.assert_array_equal(banded.wave_rays, full.wave_rays)


@pytest.fixture(scope="module")
def backlit_scene():
    """Backlit self-hit regression: the light is BELOW the floor, so a shadow
    ray from a front (top) hit crosses the floor's own plane at tiny t — its
    NEAREST intersection is the origin triangle itself.  A real occluder
    farther along (between floor and light) must still shadow the pixel:
    any-OTHER-occluder semantics (oracle.is_shadowed; the commented design at
    raytrace.rs:1204-1224) require excluding the origin triangle by id, not
    just taking the nearest hit."""
    floor = make_triangles(
        np.asarray([[[-10, -2, -5], [10, -2, -5], [0, -2, 25]]], dtype=F32),
        solid(m3.make_color((200, 200, 200))), 0.0)
    occ = make_triangles(
        np.asarray([[[-8, -6, -2], [8, -6, -2], [0, -6, 20]]], dtype=F32),
        solid(m3.make_color((250, 50, 50))), 0.0)
    scene = assemble([floor, occ])
    scene.lights = LightSource(orig=np.asarray([0.0, -20.0, 6.0], dtype=F32),
                               len2=0.0)
    return scene


def test_backlit_self_hit_still_finds_occluder(backlit_scene, vp):
    img_o = oracle.render(backlit_scene.tris, vp, rng=oracle.FixedRng(),
                          lights=backlit_scene.lights)
    eng = Engine(backlit_scene, page_size=64, ray_chunk=256, interpret=True)
    res = eng.render(vp, fixed_rng=True, quantize=False)
    # the oracle shadows the floor through the self-hit; the engine must too
    floor_shadowed_o = (img_o.max(axis=-1) < 1e-6)
    assert floor_shadowed_o.any()
    diff = np.abs(res.image - img_o).max(axis=-1)
    assert (diff > 1 / 255).mean() < 0.01
