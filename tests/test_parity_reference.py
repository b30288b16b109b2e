"""Parity gate vs the reference's SHIPPED golden.

Renders the main.rs scene at 1/8 of the 4k golden's resolution on CPU and
gates the deterministic structure against a box-downsampled
/root/reference/teapot_4k_tris.png: sky constancy and silhouette IoU.  A
geometry, camera, transform, or shading regression flips this gate — the
in-repo goldens alone couldn't catch a bug baked into both our oracle and
our renderers.
"""

import numpy as np
import pytest

from rust_raytrace_tpu.scene import reference_asset
from rust_raytrace_tpu.utils.parity import (downsample_u8, parity_stats,
                                            sky_mask, GOLDEN_SKY)
from rust_raytrace_tpu.utils.png import quantize_u8, read_png

FACTOR = 8          # 3840x2160 -> 480x270


@pytest.fixture(scope="module")
def golden_small():
    path = reference_asset("teapot_4k_tris.png")
    if path is None:
        pytest.skip("reference teapot_4k_tris.png not available")
    return downsample_u8(read_png(path), FACTOR)


@pytest.fixture(scope="module")
def ours_small():
    from rust_raytrace_tpu.engine import Engine
    from rust_raytrace_tpu.models import teapot

    scene, vp = teapot.build(resolution=(3840 // FACTOR, 2160 // FACTOR))
    eng = Engine(scene, page_size=64, ray_chunk=512, interpret=True)
    res = eng.render(vp, quantize=True)
    return res.image.astype(np.float32)


@pytest.mark.needs_teapot
def test_parity_vs_shipped_golden(golden_small, ours_small):
    stats = parity_stats(ours_small, golden_small)
    # sky: constant, within the golden-era drift (127,178,255 vs 128,180,255)
    # plus downsample bleed at silhouettes
    assert stats["sky_fraction_golden"] > 0.5
    assert stats["sky_mean_abs_diff"] < 4.0, stats
    # silhouette: the geometry footprint must align (IoU catches camera /
    # transform / mesh regressions; downsampling + bounce noise costs a
    # little overlap, a real regression costs a lot).  Most of the residual
    # is the golden's second disk, drawn larger than the shipped source's
    # radius (docs/PARITY.md), so the gate sits just under the measured
    # overlap, not at a forgiving 0.8
    assert stats["silhouette_iou"] > 0.95, stats


def test_parity_stats_error_norms():
    """rmse must be sqrt(mean(sq)) and mae mean(|diff|) — pinned on a
    synthetic pair where the two differ by construction (a formula once
    computed MAE under the name rmse)."""
    a = np.zeros((2, 2, 3), dtype=np.float32)
    b = np.zeros((2, 2, 3), dtype=np.float32)
    b[0, 0, :] = 255.0          # 3 of 12 channels differ by 1.0 (normalized)
    stats = parity_stats(a, b)
    assert stats["mae"] == pytest.approx(3.0 / 12.0)
    assert stats["rmse"] == pytest.approx(np.sqrt(3.0 / 12.0))
    assert stats["rmse"] > stats["mae"]


@pytest.mark.needs_teapot
def test_parity_gate_detects_regressions(golden_small, ours_small):
    """The gate must actually trip on representative breakages."""
    # camera shift: roll the image by ~5% of its width — and a SMALL one
    # (~1.5%) that the old 0.8 gate slept through but the 0.95 gate trips
    shifted = np.roll(ours_small, ours_small.shape[1] // 20, axis=1)
    assert parity_stats(shifted, golden_small)["silhouette_iou"] < 0.8
    nudged = np.roll(ours_small, max(ours_small.shape[1] // 64, 4), axis=1)
    assert parity_stats(nudged, golden_small)["silhouette_iou"] < 0.95
    # sky-color regression: the CUDA sky constant (128,178,255) is FINE
    # (within drift), but a wrong sky (e.g. 140,180,255) is not
    broken = ours_small.copy()
    sky = sky_mask(ours_small, np.asarray([128, 180, 255], np.float32))
    broken[sky] = np.asarray([140, 180, 255], np.float32)
    assert parity_stats(broken, golden_small)["sky_mean_abs_diff"] > 4.0
