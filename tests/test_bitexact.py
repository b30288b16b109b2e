"""Bit-exactness contract across the three implementations.

What is promised (and enforced here), under FixedRng at spp == 1:

  1. Engine (production culled+compacted wavefront, trace kernel in
     interpret mode) == WavefrontRenderer("xla"): max |diff| == 0.0.  The
     two share the shading algebra but differ in everything else (front-to-
     back traversal vs brute force, compaction vs in-place) — equality is
     the strongest cross-check.
  2. Both vs the recursive numpy oracle: <= 1 ULP of 2^-23 per channel.
     The oracle evaluates mix_color recursively (c_surf*(1-a) + a*child,
     raytrace.rs:1199-1254); the wavefront unrolls it into a running
     (accum, weight) pair — the same polynomial with a different
     association order, so f32 rounding may differ in the last bit.
     Exact 0.0 against the oracle is NOT promised (and CLAUDE.md says so).

The contract holds under CPU compilation.  On a GPU the trace kernel and
XLA contract multiply-adds differently, so a few marginal predicates flip;
chip_smoke.py bounds that share.
"""

import numpy as np
import pytest

from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.engine import Engine
from rust_raytrace_tpu.render import WavefrontRenderer
from rust_raytrace_tpu.utils.png import quantize_u8

ULP = 1.1920929e-07  # 2**-23


SCENES = ["circles", pytest.param("teapot", marks=pytest.mark.needs_teapot)]


def _scene(name, resolution):
    from rust_raytrace_tpu.models import circles, teapot

    return {"circles": circles, "teapot": teapot}[name].build(
        resolution=resolution)


@pytest.mark.parametrize("name", SCENES)
def test_engine_equals_xla_equals_oracle(name):
    scene, vp = _scene(name, (48, 32))
    img_o = oracle.render(scene.tris, vp, rng=oracle.FixedRng())

    wr = WavefrontRenderer(scene, page_size=64)
    img_x = wr.render(vp, fixed_rng=True).image

    for trace in ("kernel", "xla"):
        eng = Engine(scene, page_size=64, ray_chunk=256, interpret=True,
                     trace=trace)
        assert eng.compact
        img_e = eng.render(vp, fixed_rng=True, quantize=False).image
        # (1) production engine == portable xla, bitwise
        np.testing.assert_array_equal(img_e, img_x)
    # (2) both vs the recursive oracle: at most 1 ULP
    assert np.abs(img_e - img_o).max() <= ULP
    assert np.abs(img_x - img_o).max() <= ULP
    # and the 1-ULP slack never flips the PNG quantization on this scene
    np.testing.assert_array_equal(quantize_u8(img_e), quantize_u8(img_o))


@pytest.mark.parametrize("name", SCENES)
def test_engine_compact_equals_no_compact(name):
    """Compaction is a pure permutation: switching it off must not change a
    single bit of the image."""
    scene, vp = _scene(name, (48, 32))
    e1 = Engine(scene, page_size=64, ray_chunk=256, interpret=True,
                compact=True)
    e0 = Engine(scene, page_size=64, ray_chunk=256, interpret=True,
                compact=False)
    i1 = e1.render(vp, fixed_rng=True, quantize=False).image
    i0 = e0.render(vp, fixed_rng=True, quantize=False).image
    np.testing.assert_array_equal(i1, i0)


@pytest.mark.needs_teapot
def test_lights_fused_equals_unfused():
    """Lights bit-exactness contract: the compacted engine traces its
    shadow feelers on compacted rays, the compact=False engine on the full
    batch.  Under FixedRng both build identical shadow rays (u3 = u1 = 0.5
    constants), so the images must agree BITWISE — the lights analog of
    test_engine_compact_equals_no_compact."""
    from rust_raytrace_tpu.models import teapot
    from rust_raytrace_tpu.scene import LightSource

    # maxdepth 3: three waves exercise wave-0 and bounce feelers
    scene, vp = teapot.build(resolution=(32, 24), maxdepth=3)
    scene.lights = LightSource(orig=np.asarray([0.0, 18.0, 8.0],
                                               dtype=np.float32), len2=0.5)
    e1 = Engine(scene, page_size=64, ray_chunk=256, interpret=True,
                compact=True)
    e0 = Engine(scene, page_size=64, ray_chunk=256, interpret=True,
                compact=False)
    i1 = e1.render(vp, fixed_rng=True, quantize=False).image
    i0 = e0.render(vp, fixed_rng=True, quantize=False).image
    np.testing.assert_array_equal(i1, i0)
    # and the shadow feeler must actually bite somewhere
    scene.lights = None
    nolight = Engine(scene, page_size=64, ray_chunk=256,
                     interpret=True).render(vp, fixed_rng=True,
                                            quantize=False).image
    assert (np.abs(i1 - nolight) > 1 / 255).any()


def test_spp4_compact_equals_legacy():
    """Compacted spp > 1: samples are just rays to the compacted pipeline
    (the final box-filter average is the only spp-aware op), so the compact
    and uncompacted engines must agree bitwise."""
    from rust_raytrace_tpu.models import circles

    scene, vp = circles.build(resolution=(64, 36), maxdepth=4, samples=4)
    e1 = Engine(scene, page_size=64, ray_chunk=128, interpret=True,
                compact=True)
    e0 = Engine(scene, page_size=64, ray_chunk=128, interpret=True,
                compact=False)
    i1 = e1.render(vp, fixed_rng=True, quantize=False).image
    i0 = e0.render(vp, fixed_rng=True, quantize=False).image
    np.testing.assert_array_equal(i1, i0)
    q1 = e1.render(vp, fixed_rng=True, quantize=True).image
    q0 = e0.render(vp, fixed_rng=True, quantize=True).image
    np.testing.assert_array_equal(q1, q0)
