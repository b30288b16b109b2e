"""Differential tests of the brute-force nearest-hit implementations.

Methodology follows the reference's own (kernel vs pure-host model diffed per
ray, cuda_raytrace.rs:387-420):
  - numpy model (intersect_ref)  vs  geometric brute force (oracle.intersect_all)
  - XLA scan (intersect_xla)     vs  numpy model (same formulas)
The culled traversals (ops/trace.py) are checked in test_trace.py.
"""

import numpy as np
import pytest

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu import oracle
from rust_raytrace_tpu.camera import camera_rays, create_viewport
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import solid
from rust_raytrace_tpu.ops.intersect_ref import nearest_hit_model
from rust_raytrace_tpu.ops.pages import build_pages
from rust_raytrace_tpu.scene import assemble

F32 = np.float32


@pytest.fixture(scope="module")
def sphere_scene():
    """Sentinel + a 148-triangle sphere shell + one floor triangle."""
    s = make_sphere((0.0, 0.0, 6.0), 2.0, (8, 12),
                    solid(m3.make_color((200, 60, 60))), -1.0)
    floor = make_triangles(
        np.asarray([[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]], dtype=F32),
        solid(m3.make_color((120, 120, 120))), 0.0)
    return assemble([s, floor])


@pytest.fixture(scope="module")
def rays():
    vp = create_viewport((24, 18), (1.0, 0.75), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, 1)
    return camera_rays(vp)


def brute_force_expected(tris, O, D):
    ts, ids = [], []
    for o, d in zip(O, D):
        hit = oracle.nearest_hit(tris, o, d)
        if hit is None:
            ts.append(np.inf)
            ids.append(0)
        else:
            ts.append(hit[0])
            ids.append(hit[1])
    return np.asarray(ts, dtype=F32), np.asarray(ids, dtype=np.int32)


@pytest.mark.parametrize("page_size", [64, 128])
def test_model_matches_geometric_bruteforce(sphere_scene, rays, page_size):
    O, D = rays
    pages = build_pages(sphere_scene.tris, page_size=page_size)
    t_m, id_m = nearest_hit_model(O, D, pages)
    t_e, id_e = brute_force_expected(sphere_scene.tris, O, D)

    # Hit/miss sets must agree exactly; hit ids may differ only via fp ties.
    assert ((id_m == 0) == (id_e == 0)).all()
    hit = id_e != 0
    # hit distance agreement (different formula arrangement -> tolerance)
    np.testing.assert_allclose(t_m[hit], t_e[hit], rtol=1e-4, atol=1e-5)
    mismatch = (id_m != id_e) & hit
    assert mismatch.mean() < 0.01, np.nonzero(mismatch)


def test_xla_matches_model(sphere_scene, rays):
    import jax.numpy as jnp

    from rust_raytrace_tpu.ops.intersect_xla import nearest_hit_xla

    O, D = rays
    pages = build_pages(sphere_scene.tris, page_size=64)
    t_m, id_m = nearest_hit_model(O, D, pages)
    t_x, id_x = nearest_hit_xla(jnp.asarray(O), jnp.asarray(D),
                                jnp.asarray(pages.PK))
    t_x, id_x = np.asarray(t_x), np.asarray(id_x)

    assert (id_x == id_m).mean() > 0.999
    both = np.isfinite(t_m) & np.isfinite(t_x)
    np.testing.assert_allclose(t_x[both], t_m[both], rtol=1e-5, atol=1e-6)
    assert ((id_x == 0) == (id_m == 0)).all()


def test_xla_excluded_id(sphere_scene, rays):
    """excl removes exactly one triangle per ray from the candidates: the
    next-nearest hit (or a miss) takes its place."""
    import jax.numpy as jnp

    from rust_raytrace_tpu.ops.intersect_xla import nearest_hit_xla

    O, D = rays
    pages = build_pages(sphere_scene.tris, page_size=64)
    PK = jnp.asarray(pages.PK)
    _, id0 = nearest_hit_xla(jnp.asarray(O), jnp.asarray(D), PK)
    t1, id1 = nearest_hit_xla(jnp.asarray(O), jnp.asarray(D), PK, id0)
    id0, id1, t1 = np.asarray(id0), np.asarray(id1), np.asarray(t1)
    assert (id0 != 0).any()
    # expected: the numpy model's nearest hit among the other triangles
    from rust_raytrace_tpu.ops.intersect_ref import _page_hits
    best_t = np.full(len(O), np.inf, np.float32)
    best_id = np.zeros(len(O), np.int32)
    for p in range(pages.num_pages):
        tt, ids = _page_hits(pages.PK[p], O, D)
        tt = np.where(ids[:, None] == id0[None, :], np.inf, tt)
        m = tt.min(axis=0)
        sel = np.where(tt == m[None, :], ids[:, None], np.inf).min(axis=0)
        upd = m < best_t
        best_t = np.where(upd, m, best_t)
        best_id = np.where(upd, sel.astype(np.int32), best_id)
    assert (id1 == best_id).mean() > 0.999
    assert ((id1 != 0) & (id0 != 0)).any()     # some rays hit a second one
    assert not ((id1 == id0) & (id0 != 0)).any()


def test_sentinel_and_padding_never_hit(sphere_scene):
    """Aim all rays above the scene; every ray must report the miss sentinel."""
    O, D = camera_rays(create_viewport((16, 16), (1.0, 1.0), (0.0, 0.0, 0.0),
                                       m3.unit(m3.vec(0.0, 1.0, 0.0)), 90.0,
                                       0.0, 5, 1))
    pages = build_pages(sphere_scene.tris, page_size=64)
    t_m, id_m = nearest_hit_model(O, D, pages)
    # camera looks away from the scene -> everything misses
    assert (id_m == 0).all()
    assert np.isinf(t_m).all()
