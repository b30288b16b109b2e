"""The culled traversals (ops/trace.py) against the numpy contract model.

The GPU kernel runs here in the Pallas interpreter (interpret=True); the
plain-XLA version runs as it does on the card.  Both must return the
brute-force lexicographic (t, id) winner (intersect_ref, tie="lex") for
every live ray, whatever the page size, bank size or ray mix.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, solid
from rust_raytrace_tpu.ops import trace as tr
from rust_raytrace_tpu.ops.intersect_ref import _page_hits, nearest_hit_model
from rust_raytrace_tpu.ops.pages import build_pages_kd
from rust_raytrace_tpu.scene import assemble

F32 = np.float32
IMPLS = ["kernel", "plain"]


def run(impl, tables, O, D, live, excl=None, any_hit=False):
    args = (tables, jnp.asarray(O.T), jnp.asarray(D.T), jnp.asarray(live),
            None if excl is None else jnp.asarray(excl))
    if impl == "kernel":
        t, i = tr.trace_kernel(*args, any_hit=any_hit, interpret=True)
    else:
        t, i = tr.trace_plain(*args, any_hit=any_hit, chunk=tr.BLOCK)
    return np.asarray(t), np.asarray(i)


@pytest.fixture(scope="module")
def scene():
    """A sphere shell, a floor, and a random triangle soup inside."""
    rng = np.random.default_rng(7)
    soup = rng.uniform(-2, 2, (60, 1, 3)) + rng.uniform(-0.4, 0.4, (60, 3, 3))
    soup = (soup + np.asarray([0.0, 0.0, 6.0])).astype(F32)
    return assemble([
        make_sphere((0.0, 0.0, 6.0), 3.0, (10, 14),
                    matte(m3.make_color((200, 60, 60)), 0.3), 0.05),
        make_triangles(np.asarray([[[-20, -4, -10], [20, -4, -10],
                                    [0, -4, 40]]], F32),
                       solid(m3.make_color((90, 90, 90))), 0.0),
        make_triangles(soup, solid(m3.make_color((20, 200, 20))), 0.0)])


def ray_mix(n, seed=0):
    """Camera-like rays from outside plus scattered rays from inside."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(n // 2, 3)) * [0.3, 0.3, 0.0] + [0, 0, 1]
    o1 = np.zeros((n // 2, 3))
    o2 = rng.uniform(-2.5, 2.5, (n - n // 2, 3)) + [0, 0, 6]
    d2 = rng.normal(size=(n - n // 2, 3))
    D = np.concatenate([d1, d2])
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return np.concatenate([o1, o2]).astype(F32), D.astype(F32)


def occluded_model(pages, O, D, excl):
    occ = np.zeros(len(O), bool)
    for p in range(pages.num_pages):
        tt, ids = _page_hits(pages.PK[p], O, D)
        occ |= (np.isfinite(tt) & (ids[:, None] != excl[None, :])).any(0)
    return occ


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("page_size", [24, 1])
def test_nearest_matches_model(scene, impl, page_size):
    """page_size 24 pads each page to 32 slots; page_size 1 makes more than
    MAX_BANKS pages, so banks hold several pages each."""
    pages = build_pages_kd(scene.tris, page_size=page_size)
    tables = tr.build_trace_tables(pages)
    assert tables.page_slots == (32 if page_size == 24 else 1)
    if page_size == 1:
        assert pages.num_pages > tr.MAX_BANKS and tables.bank_pages > 1
    O, D = ray_mix(512)
    live = np.ones(len(O), bool)
    live[::5] = False
    t, i = run(impl, tables, O, D, live)
    t_m, i_m = nearest_hit_model(O, D, pages, tie="lex")
    assert (i_m[live] != 0).mean() > 0.5
    np.testing.assert_array_equal(i[live], i_m[live])
    hit = live & (i_m != 0)
    np.testing.assert_allclose(t[hit], t_m[hit], rtol=1e-5, atol=1e-6)
    # dead rays report a miss
    assert (i[~live] == 0).all() and np.isinf(t[~live]).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_misses_and_dead_blocks(scene, impl):
    """Rays that leave the scene (empty candidate lists) miss; a block with
    no live ray at all returns misses and does no work."""
    pages = build_pages_kd(scene.tris, page_size=16)
    tables = tr.build_trace_tables(pages)
    n = 2 * tr.BLOCK
    O = np.tile(np.asarray([0.0, 50.0, 0.0], F32), (n, 1))
    D = np.tile(np.asarray([0.0, 1.0, 0.0], F32), (n, 1))   # away, up
    live = np.arange(n) >= tr.BLOCK                         # block 0 dead
    t, i = run(impl, tables, O, D, live)
    assert (i == 0).all() and np.isinf(t).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_front_to_back_exit_keeps_nearest(impl):
    """Walls one behind another along the rays, each in its own page and
    bank: the nearest wall wins however far the others are, and of two
    coincident triangles the smaller id wins even though both sit at the
    same entry bound (the exit must not fire on equality)."""
    walls = []
    for z in (9.0, 3.0, 6.0, 3.0):
        walls.append([[-5, -5, z], [5, -5, z], [0, 6, z]])
    s = assemble([make_triangles(np.asarray(walls, F32),
                                 solid(m3.make_color((200, 200, 200))), 0.0)])
    pages = build_pages_kd(s.tris, page_size=1)
    tables = tr.build_trace_tables(pages)
    assert tables.num_pages == 4
    O, _ = ray_mix(tr.BLOCK)
    O = np.zeros_like(O)
    D = np.tile(np.asarray([0.0, 0.0, 1.0], F32), (tr.BLOCK, 1))
    D[:, :2] = np.random.default_rng(1).uniform(-0.2, 0.2, (tr.BLOCK, 2))
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    live = np.ones(tr.BLOCK, bool)
    t, i = run(impl, tables, O, D, live)
    assert (i == 2).all()                  # ids 2 and 4 coincide at z = 3
    np.testing.assert_allclose(t, 3.0 / D[:, 2], rtol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_any_hit_with_exclusion(scene, impl):
    """Any-hit mode with a per-ray excluded triangle (shadow feelers): the
    occlusion flag equals 'some other triangle is hit'."""
    pages = build_pages_kd(scene.tris, page_size=16)
    tables = tr.build_trace_tables(pages)
    O, D = ray_mix(256, seed=3)
    live = np.ones(len(O), bool)
    live[1::7] = False
    _, i_m = nearest_hit_model(O, D, pages, tie="lex")
    excl = np.where(live, i_m, 0).astype(np.int32)
    _, i = run(impl, tables, O, D, live, excl=excl, any_hit=True)
    occ = occluded_model(pages, O, D, excl) & live
    assert 0.05 < occ.mean() < 0.95
    np.testing.assert_array_equal(i != 0, occ)
    assert not ((i == excl) & (i != 0)).any()


def test_kernel_equals_plain_bitwise(scene):
    """On the CPU both traversals compile the same predicate arithmetic, so
    their (t, id) agree bit for bit."""
    pages = build_pages_kd(scene.tris, page_size=8)
    tables = tr.build_trace_tables(pages)
    O, D = ray_mix(384, seed=5)
    live = np.ones(len(O), bool)
    a = run("kernel", tables, O, D, live)
    b = run("plain", tables, O, D, live)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_bank_boxes_are_conservative(scene):
    """Every ray's slab entry into a bank (and into each of its pages) is
    at most its hit distance on any triangle of the bank: the kernel's
    front-to-back exit and page skips rely on it."""
    from rust_raytrace_tpu.ops.cull import inv_dir, slab

    pages = build_pages_kd(scene.tris, page_size=1)
    tables = tr.build_trace_tables(pages)
    G = tables.bank_pages
    assert G > 1
    O, D = ray_mix(256, seed=9)
    o3 = tuple(jnp.asarray(O[:, k]) for k in range(3))
    i3 = tuple(inv_dir(jnp.asarray(D[:, k])) for k in range(3))

    def entry(box):
        hit, e = slab(o3, i3, tuple(box[0:3]), tuple(box[4:7]))
        return np.where(np.asarray(hit), np.asarray(e), np.inf)

    banks = np.asarray(tables.bank_box)
    boxes = np.asarray(tables.page_box)
    for p in range(pages.num_pages):
        tt, _ = _page_hits(pages.PK[p], O, D)
        t_hit = tt.min(axis=0)
        assert (entry(boxes[p]) <= t_hit).all()
        assert (entry(banks[p // G]) <= t_hit).all()
    # padding rows are marked empty (lo = +inf); both traversals skip them
    assert (boxes[pages.num_pages:, 0:3] == np.inf).all()


def test_hit_terms_match_model(scene):
    """The shared predicate (hit_terms) equals the numpy contract model on
    one page, t to within rounding and the hit set exactly."""
    pages = build_pages_kd(scene.tris, page_size=32)
    O, D = ray_mix(128, seed=2)
    pk = pages.PK[3]
    t, ok = tr.hit_terms(lambda f: jnp.asarray(pk[:, f:f + 1]),
                         tuple(jnp.asarray(O[None, :, k]) for k in range(3)),
                         tuple(jnp.asarray(D[None, :, k]) for k in range(3)))
    tt_m, _ = _page_hits(pk, O, D)
    ok = np.asarray(ok)
    np.testing.assert_array_equal(ok, np.isfinite(tt_m))
    np.testing.assert_allclose(np.asarray(t)[ok], tt_m[ok], rtol=1e-5)


@pytest.mark.gpu
def test_kernel_compiled_for_gpu_matches_plain(gpu, scene):
    """The trace kernel as Triton compiles it for the card (no interpreter)
    against the plain-XLA traversal, nearest and any-hit.  chip_smoke.py
    phase 2 runs the same comparison at full width."""
    pages = build_pages_kd(scene.tris, page_size=32)
    tables = tr.build_trace_tables(pages)
    O, D = ray_mix(1024, seed=11)
    live = np.ones(len(O), bool)
    args = (tables, jnp.asarray(O.T), jnp.asarray(D.T), jnp.asarray(live))
    t, i = map(np.asarray, tr.trace_kernel(*args))
    t_p, i_p = map(np.asarray, tr.trace_plain(*args, chunk=tr.BLOCK))
    assert (i == i_p).mean() >= 0.999
    same = (i == i_p) & (i != 0)
    np.testing.assert_allclose(t[same], t_p[same], rtol=1e-5, atol=1e-5)
    _, a = tr.trace_kernel(*args, jnp.asarray(i_p), any_hit=True)
    _, a_p = tr.trace_plain(*args, jnp.asarray(i_p), any_hit=True,
                            chunk=tr.BLOCK)
    assert ((np.asarray(a) != 0) == (np.asarray(a_p) != 0)).mean() >= 0.999
