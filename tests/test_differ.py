"""End-to-end ray differ with candidate sets.

The reference's main debugging loop: render with two backends, record each
ray's candidate-triangle set and winning hit, classify every mismatch
(debug.rs:150-222, driven from main.rs:206-227).  These tests run that loop
for real: oracle (octree-walk candidates, raytrace.rs:1018-1021) vs engine
(packet-cull page-list candidates), then verify an artificially broken cull
is caught and classified.
"""

import io

import numpy as np
import pytest

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine
from rust_raytrace_tpu.geometry import make_sphere
from rust_raytrace_tpu.materials import matte
from rust_raytrace_tpu.octree import build_bounding_box
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu.utils.raydebug import DebugCtx, from_render_result


@pytest.fixture(scope="module")
def scene():
    return assemble([make_sphere((0.0, 0.0, 6.0), 2.0, (8, 12),
                                 matte(m3.make_color((252, 119, 0)), 0.2),
                                 0.05)])


@pytest.fixture(scope="module")
def vp():
    return create_viewport((24, 24), (1.0, 1.0), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 2, 1)


@pytest.fixture(scope="module")
def traces(scene, vp):
    # oracle trace with octree-walk candidate sets
    tree = build_bounding_box(scene.tris, (0.0, 0.0, 6.0), 8.0, 4, 4)
    octx = DebugCtx()
    oracle.render(scene.tris, vp, rng=oracle.FixedRng(), debug_ctx=octx,
                  octree=tree)
    # engine trace with packet-cull candidate sets
    eng = Engine(scene, page_size=16, ray_chunk=128, interpret=True)
    res = eng.render(vp, fixed_rng=True, debug=True, quantize=False)
    ectx = from_render_result(res, vp)
    return octx, ectx


def test_candidate_sets_are_populated(traces):
    octx, ectx = traces
    o_with = sum(1 for c in octx.checks.values() if c.check_tris)
    e_with = sum(1 for c in ectx.checks.values() if c.check_tris)
    assert o_with > 0 and e_with > 0
    # engine candidate sets are chunk-granular SUPERSETS of the per-ray
    # octree sets on hit pixels (the cull is conservative)
    for px, oc in octx.checks.items():
        if oc.tri_hit != 0:
            ec = ectx.checks[px]
            assert oc.tri_hit in ec.check_tris


def test_backends_agree(traces):
    octx, ectx = traces
    out = io.StringIO()
    err = ectx.compare_to(octx, out)
    assert err == 0, out.getvalue()


def test_broken_cull_is_classified(traces):
    """Simulate a cull bug: the engine misses a hit whose triangle never
    entered its candidate list.  The differ must flag it with the
    reference's classification string (debug.rs:181-192; note the reference
    wording: a missing candidate prints 'Bad hit detection for ray', a
    candidate that was tested-but-missed prints 'Their hit not in our tri
    list' — quirky, but ours must match the reference exactly)."""
    octx, ectx = traces
    px = next(px for px, c in octx.checks.items() if c.tri_hit != 0)
    broken = ectx.checks[px]
    hit = octx.checks[px].tri_hit
    orig_hit, orig_tris = broken.tri_hit, list(broken.check_tris)
    try:
        broken.tri_hit = 0
        broken.check_tris = [t for t in broken.check_tris if t != hit]
        out = io.StringIO()
        err = ectx.compare_to(octx, out)
        assert err == 1
        assert "Bad hit detection for ray" in out.getvalue()

        # and the tested-but-missed variant
        broken.check_tris = orig_tris
        out = io.StringIO()
        err = ectx.compare_to(octx, out)
        assert err == 1
        assert "Their hit not in our tri list" in out.getvalue()
    finally:
        broken.tri_hit = orig_hit
        broken.check_tris = orig_tris
