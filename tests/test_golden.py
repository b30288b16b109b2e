"""Golden-image regression tests.

tests/goldens/*.png are deterministic fixed-rng oracle renders committed to
the repo (the analog of the reference's checked-in golden PNGs — which its
own shipped scenes can't reproduce bit-exactly because its shading consumes
thread-local RNG; ours can, because the RNG is injectable).

The wavefront backends must reproduce them through the full pipeline
including PNG quantization.
"""

import os

import numpy as np
import pytest


from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.engine import Engine
from rust_raytrace_tpu.models import circles, multi, teapot
from rust_raytrace_tpu.render import WavefrontRenderer
from rust_raytrace_tpu.utils import png

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _check(scene, vp, golden_name):
    """Both backends must reproduce the golden EXACTLY under fixed_rng:
    test_bitexact.py proves engine == xla == quantized oracle, so any pixel
    tolerance here would be dead slack hiding real one-pixel regressions."""
    golden = png.read_png(os.path.join(GOLDENS, golden_name))

    simple = WavefrontRenderer(scene, page_size=128)
    img_s = png.quantize_u8(simple.render(vp, fixed_rng=True).image)
    np.testing.assert_array_equal(img_s, golden, err_msg=f"simple vs {golden_name}")

    eng = Engine(scene, page_size=128, ray_chunk=512, interpret=True)
    img_e = eng.render(vp, fixed_rng=True).image
    np.testing.assert_array_equal(img_e, golden, err_msg=f"engine vs {golden_name}")

    eng = Engine(scene, page_size=128, ray_chunk=512, trace="xla")
    img_e = eng.render(vp, fixed_rng=True).image
    np.testing.assert_array_equal(img_e, golden, err_msg=f"engine vs {golden_name}")


def test_circles_golden():
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    _check(scene, vp, "circles_96x54.png")


@pytest.mark.needs_teapot
def test_teapot_golden():
    scene, vp = teapot.build(resolution=(96, 54), maxdepth=5)
    _check(scene, vp, "teapot_96x54.png")


@pytest.mark.needs_teapot
def test_multi_golden():
    scene, vp = multi.build(resolution=(64, 36), maxdepth=4)
    _check(scene, vp, "multi_64x36.png")


def _regen(build, golden_name, **kw):
    scene, vp = build(**kw)
    img = oracle.render(scene.tris, vp, rng=oracle.FixedRng())
    golden = png.read_png(os.path.join(GOLDENS, golden_name))
    np.testing.assert_array_equal(png.quantize_u8(img), golden)


@pytest.mark.parametrize("name", [
    "circles", pytest.param("multi", marks=pytest.mark.needs_teapot),
    pytest.param("teapot", marks=pytest.mark.needs_teapot)])
def test_goldens_regenerate_exactly(name):
    """Every committed golden is byte-identical to a fresh oracle render
    (guards the oracle and the PNG quantization against drift — the
    CLAUDE.md invariant).  multi instances the teapot mesh, so its golden
    needs the mesh too."""
    build, res, depth = {"circles": (circles.build, (96, 54), 5),
                         "multi": (multi.build, (64, 36), 4),
                         "teapot": (teapot.build, (96, 54), 5)}[name]
    _regen(build, f"{name}_{res[0]}x{res[1]}.png", resolution=res,
           maxdepth=depth)
