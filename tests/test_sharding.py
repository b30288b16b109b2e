"""Multi-device image-tile data parallelism tests (8 virtual CPU devices)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import camera_rays, create_viewport
from rust_raytrace_tpu.engine import Engine
from rust_raytrace_tpu.geometry import make_sphere
from rust_raytrace_tpu.materials import matte
from rust_raytrace_tpu.parallel.sharding import (TILE_AXIS,
                                                 engine_render_sharded,
                                                 make_mesh, shard_rays,
                                                 trace_rays_sharded)
from rust_raytrace_tpu.render import upload_scene
from rust_raytrace_tpu.scene import LightSource, assemble

F32 = np.float32


@pytest.fixture(scope="module")
def scene():
    return assemble([make_sphere((0.0, 0.0, 6.0), 2.0, (8, 12),
                                 matte(m3.make_color((252, 119, 0)), 0.2),
                                 0.05)])


@pytest.fixture(scope="module")
def vp():
    return create_viewport((32, 32), (1.0, 1.0), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 3, 1)


def test_mesh_has_8_devices():
    mesh = make_mesh(8)
    assert mesh.shape["tiles"] == 8


def test_make_mesh_refuses_missing_devices():
    """No silent fallback to other devices: asking for more devices than
    the backend has is an error that names the fix."""
    with pytest.raises(ValueError, match="xla_force_host_platform"):
        make_mesh(16)


def test_sharded_trace_matches_single(scene, vp):
    st = upload_scene(scene, page_size=64)
    o, d = camera_rays(vp)
    mesh = make_mesh(8)
    os, ds = shard_rays(jnp.asarray(o), jnp.asarray(d), mesh)

    colors, wave_rays = trace_rays_sharded(
        st, os, ds, jax.random.PRNGKey(0), mesh, maxdepth=vp.maxdepth,
        fixed_rng=True)
    colors = np.asarray(colors)
    assert int(np.asarray(wave_rays)[0]) == o.shape[0]

    from rust_raytrace_tpu.render import trace_rays

    colors1, aux1 = trace_rays(st, jnp.asarray(o), jnp.asarray(d),
                               jax.random.PRNGKey(0), maxdepth=vp.maxdepth,
                               fixed_rng=True)
    np.testing.assert_allclose(colors, np.asarray(colors1), atol=1e-6)


def test_engine_sharded_bitexact(scene, vp):
    """Sharded production engine == unsharded engine BIT-EXACT under
    FixedRng: per-ray values are independent of which rays share a device
    or a kernel block, and under fixed_rng the per-device key fold is
    inert.  The unsharded comparator runs without compaction, which must
    not matter either — compaction only moves rays between slots."""
    eng = Engine(scene, page_size=64, ray_chunk=128, interpret=True)
    flat = Engine(scene, page_size=64, ray_chunk=128, interpret=True,
                  compact=False)
    r1 = flat.render(vp, fixed_rng=True, quantize=False)
    r8 = eng.render_sharded(vp, mesh=make_mesh(8), fixed_rng=True,
                            quantize=False)
    np.testing.assert_array_equal(r8.image, r1.image)
    np.testing.assert_array_equal(r8.wave_rays, r1.wave_rays)


def test_engine_sharded_lights_bitexact(scene, vp):
    """Sharded engine on a LIGHTS scene == unsharded BITWISE: the light
    constants are replicated to every device and the shadow feelers run per
    shard (rays, feelers included, are independent)."""
    lscene = assemble([make_sphere((0.0, 0.0, 6.0), 2.0, (8, 12),
                                   matte(m3.make_color((252, 119, 0)), 0.2),
                                   0.05)])
    lscene.lights = LightSource(orig=np.asarray([0.0, 12.0, 4.0], dtype=F32),
                                len2=0.25)
    eng = Engine(lscene, page_size=64, ray_chunk=128, interpret=True)
    r1 = eng.render(vp, fixed_rng=True)
    r8 = eng.render_sharded(vp, mesh=make_mesh(8), fixed_rng=True)
    # the light must actually darken something vs an unlit render — guard
    # against a silently-dropped light making this test vacuous
    unlit = Engine(scene, page_size=64, ray_chunk=128, interpret=True)
    assert (unlit.render(vp, fixed_rng=True).image != r1.image).any()
    np.testing.assert_array_equal(r8.image, r1.image)
    np.testing.assert_array_equal(r8.wave_rays, r1.wave_rays)


def test_engine_sharded_spp_bitexact(scene):
    """Sharded engine at spp=2 == unsharded BITWISE: sample groups are
    adjacent in tile order and never straddle shards, so each shard's
    on-device box filter reproduces the single-device average exactly."""
    vp2 = create_viewport((32, 32), (1.0, 1.0), (0.0, 0.0, 0.0),
                          m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 3, 2)
    eng = Engine(scene, page_size=64, ray_chunk=128, interpret=True)
    r1 = eng.render(vp2, fixed_rng=True)
    r8 = eng.render_sharded(vp2, mesh=make_mesh(8), fixed_rng=True)
    assert r8.image.dtype == np.uint8
    np.testing.assert_array_equal(r8.image, r1.image)
    np.testing.assert_array_equal(r8.wave_rays, r1.wave_rays)


def test_render_sharded_user_api(scene, vp):
    """Engine.render_sharded (the user-facing multi-chip render) ==
    Engine.render bit-exactly under fixed_rng: same viewport in, same
    RenderResult image/wave counts out — no manual camera-ray plumbing."""
    eng = Engine(scene, page_size=64, ray_chunk=128, interpret=True)
    mesh = make_mesh(8)
    r1 = eng.render(vp, fixed_rng=True)
    r8 = eng.render_sharded(vp, mesh=mesh, fixed_rng=True)
    assert r8.image.dtype == np.uint8
    np.testing.assert_array_equal(r8.image, r1.image)
    np.testing.assert_array_equal(r8.wave_rays, r1.wave_rays)
    assert r8.rays_traced == r1.rays_traced


def test_render_sharded_spp_float(scene):
    """render_sharded at spp=2 with float output == render: the raw sample
    buffer crosses shards and the host box filter reproduces the
    single-chip average bitwise (same addends, same order)."""
    vp2 = create_viewport((32, 32), (1.0, 1.0), (0.0, 0.0, 0.0),
                          m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 3, 2)
    eng = Engine(scene, page_size=64, ray_chunk=128, interpret=True)
    r1 = eng.render(vp2, fixed_rng=True, quantize=False)
    r8 = eng.render_sharded(vp2, mesh=make_mesh(8), fixed_rng=True,
                            quantize=False)
    assert r8.image.dtype == np.float32
    np.testing.assert_array_equal(r8.image, r1.image)


def test_render_sharded_debug_surface(scene, vp):
    """render_sharded(debug=True) returns the primary hit t/id buffers ==
    render(debug=True)'s bitwise under fixed_rng: each shard records its
    own wave-0 slice, so the differ (`cli diff`, debug.rs:150-222) works on
    multi-device renders."""
    eng = Engine(scene, page_size=64, ray_chunk=128, interpret=True)
    r1 = eng.render(vp, fixed_rng=True, debug=True)
    r8 = eng.render_sharded(vp, mesh=make_mesh(8), fixed_rng=True,
                            debug=True)
    assert r8.primary_t is not None and r8.primary_id is not None
    np.testing.assert_array_equal(r8.primary_id, r1.primary_id)
    np.testing.assert_array_equal(r8.primary_t, r1.primary_t)
    np.testing.assert_array_equal(r8.image, r1.image)
    # the surface is real: some pixels hit (nonzero ids) and some miss
    assert (r8.primary_id != 0).any() and (r8.primary_id == 0).any()


def test_render_sharded_multibank_bitexact():
    """render_sharded == render() bitwise on a scene split into banks of
    several pages (page_size 1: more pages than MAX_BANKS), so every shard
    runs the kernel's two-level walk for real."""
    from rust_raytrace_tpu.ops.trace import MAX_BANKS

    s = assemble([make_sphere((0.0, 0.0, 6.0), 2.5, (14, 14),
                              matte(m3.make_color((252, 119, 0)), 0.2),
                              0.0)])
    vp4 = create_viewport((32, 32), (1.0, 1.0), (0.0, 0.0, 0.0),
                          m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 4, 1)
    eng = Engine(s, page_size=1, ray_chunk=128, interpret=True)
    assert eng.tables.num_pages > MAX_BANKS and eng.tables.bank_pages > 1
    r1 = eng.render(vp4, fixed_rng=True)
    r8 = eng.render_sharded(vp4, mesh=make_mesh(8), fixed_rng=True)
    np.testing.assert_array_equal(r8.image, r1.image)
    np.testing.assert_array_equal(r8.wave_rays, r1.wave_rays)
    # the surface is real: hits and misses both present
    assert (r1.image != r1.image[:1, :1, :]).any()


def test_engine_sharded_dryrun(scene, vp):
    """The sharded program called directly on prepared tile-order rays
    (trace kernel in interpret mode, shading, compaction) over the 8-device
    mesh: shapes, dtype and the global ray counters."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    eng = Engine(scene, page_size=64, ray_chunk=64, interpret=True)
    mesh = make_mesh(8)
    R0 = vp.height * vp.width
    R = -(-R0 // (8 * eng.ray_chunk)) * 8 * eng.ray_chunk
    o, d = eng._primary_rays(vp, jax.random.PRNGKey(0), R, False)
    alive = jnp.arange(R) < R0
    rows = NamedSharding(mesh, P(TILE_AXIS))
    img, wave_counts, primary = engine_render_sharded(
        eng, jax.device_put(o, rows), jax.device_put(d, rows),
        jax.device_put(alive, rows), jax.random.PRNGKey(0), mesh,
        **eng._statics(vp, fixed_rng=False, debug=False, quant=True, spp=1))
    img = np.asarray(img)
    assert primary is None
    assert img.shape == (R, 3)
    assert img.dtype == np.uint8
    assert int(np.asarray(wave_counts)[0]) == R0
    # sky pixels present and correctly quantized
    assert (img[:, 2] == 255).any()
