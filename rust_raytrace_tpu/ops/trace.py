"""Front-to-back traversal of the KD page tables: one GPU kernel and the same
algorithm in plain XLA.

The reference's CUDA backend ran one block per ray and one thread per
candidate triangle over triangle lists the host rebuilt and uploaded every
cycle (cuda_rt.cu:145-324, 341-398), with its front-to-back early exit
disabled (cuda_raytrace.rs:441).  Here the scene stays in device memory and
each program of `trace_kernel` owns a block of BLOCK rays:

  level 1  banks of G consecutive KD pages.  The program first computes
           each bank's entry bound for its block: the least slab entry
           distance over the block's live rays.  It then visits its banks
           in increasing entry order (an argmin over that vector) and stops
           once every live ray's best hit is nearer than the next bank's
           bound.
  level 2  the bank's pages: a per-ray slab test against the page AABB.  A
           page that no ray of the block can reach before its best hit is
           skipped without loading its triangles.
  level 3  the page's triangles: the packed hit predicate (`hit_terms`) over
           a [BLOCK, P2] tile and a lexicographic (t, id) running minimum.

`trace_plain` is the plain-XLA version: an exact cull of ray chunks against
page AABBs (every live ray's slab test, reduced per chunk), each chunk's page
list sorted by entry bound, and one page per chunk per step until every
chunk's rays have a hit nearer than its next page.  XLA cannot skip work per
ray or per chunk, so every step costs the whole batch.

Contract (ops/intersect_ref.py): t is the nearest hit distance (+inf on a
miss) and id the winning triangle (0 on a miss).  Equal t break to the
smallest id, so neither result depends on the order pages are visited.  In
any-hit mode (shadow feelers) a ray stops at its first hit and only
id != 0 is meaningful.  `excl` names one triangle per ray that cannot hit
(the feeler's own surface; 0 excludes nothing).

Page AABBs are inflated by a small fraction of the scene's extent, so a slab
entry bound never exceeds the hit distance the predicate computes for a
triangle inside the page, whatever the rounding.
"""

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .cull import cull_mask_exact, inv_dir, slab
from .pages import (LANE_ID, LANE_N, LANE_NC, LANE_S0, LANE_S0C, LANE_S1,
                    LANE_S1C, LANE_S2, LANE_S2C, PageTables)

F32 = jnp.float32
INF = float("inf")

#: rays per kernel program (a power of two)
BLOCK = 64
#: most banks a scene is split into (one kernel row of entry bounds)
MAX_BANKS = 256
#: geometric lanes of the packed page layout the predicate reads (0..15)
FEATURES = LANE_ID
#: AABB inflation, relative to the scene's largest coordinate
BOX_PAD = 1e-5


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def hit_terms(feat, o3, d3):
    """The packed-triangle hit arithmetic shared by every traversal.

    Semantic reference: the plane hit plus incenter half-plane test of
    raytrace.rs:377-436 (CUDA form cuda_rt.cu:145-256), refactored into
    per-triangle packed scalars (ops/pages.py lane layout).  Written as
    elementwise products and sums, never as a matrix product, so no backend
    runs it at reduced precision.

    feat(lane) returns that feature broadcastable against the ray terms;
    o3/d3 are (x, y, z) ray terms.  Returns (t, ok).
    """
    def dot3(f, r):
        return feat(f) * r[0] + feat(f + 1) * r[1] + feat(f + 2) * r[2]

    t = (feat(LANE_NC) - dot3(LANE_N, o3)) / dot3(LANE_N, d3)
    ok = t >= 0.0
    for s, sc in ((LANE_S0, LANE_S0C), (LANE_S1, LANE_S1C),
                  (LANE_S2, LANE_S2C)):
        ok = ok & (dot3(s, o3) + t * dot3(s, d3) - feat(sc) <= 1.0)
    return t, ok


def lex_update(best_t, best_id, page_min, page_id):
    """Lexicographic (t, id) running minimum (the oracle's lowest-index tie
    rule, raytrace.rs:1029-1038)."""
    upd = (page_min < best_t) | ((page_min == best_t) & (page_min < INF)
                                & (page_id < best_id))
    return (jnp.where(upd, page_min, best_t),
            jnp.where(upd, page_id, best_id))


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["tri", "ids", "page_box", "bank_box"],
    meta_fields=["num_pages", "bank_pages"])
@dataclass
class TraceTables:
    """Device layout of the KD pages for the traversals above."""

    tri: jax.Array       # [NB*G, 16, P2] f32 feature-major page features
    ids: jax.Array       # [NB*G, P2] int32 triangle ids (0 = empty slot)
    page_box: jax.Array  # [NB*G, 8] f32 inflated AABB: lo xyz, 0, hi xyz, 0
    bank_box: jax.Array  # [NB, 8] f32 union of the bank's page boxes
    num_pages: int       # real pages; rows past it are empty padding
    bank_pages: int      # G

    @property
    def num_banks(self) -> int:
        return self.bank_box.shape[0]

    @property
    def page_slots(self) -> int:
        return self.tri.shape[2]


def build_trace_tables(pages: PageTables) -> TraceTables:
    """Repack host pages for the GPU: P padded to a power of two P2, the 16
    geometric lanes feature-major (one coalesced row per feature), ids as
    int32, pages grouped into at most MAX_BANKS banks."""
    NP, P, _ = pages.PK.shape
    P2 = _pow2(P)
    G = -(-NP // MAX_BANKS)
    NB = -(-NP // G)
    rows = NB * G

    tri = np.zeros((rows, FEATURES, P2), np.float32)
    tri[:NP, :, :P] = pages.PK[:, :, :FEATURES].transpose(0, 2, 1)
    ids = np.zeros((rows, P2), np.int32)
    ids[:NP, :P] = pages.PK[:, :, LANE_ID].astype(np.int32)

    lo = np.full((rows, 3), np.inf, np.float32)
    hi = np.full((rows, 3), -np.inf, np.float32)
    lo[:NP], hi[:NP] = pages.aabb_lo, pages.aabb_hi
    finite = np.isfinite(lo[:NP]).all(axis=1)
    scale = max(1.0, float(np.abs(np.concatenate(
        [lo[:NP][finite], hi[:NP][finite]])).max(initial=0.0)))
    pad = np.float32(BOX_PAD * scale)
    lo[:NP] -= pad
    hi[:NP] += pad
    box = np.zeros((rows, 8), np.float32)
    box[:, 0:3], box[:, 4:7] = lo, hi
    bank = np.zeros((NB, 8), np.float32)
    bank[:, 0:3] = lo.reshape(NB, G, 3).min(axis=1)
    bank[:, 4:7] = hi.reshape(NB, G, 3).max(axis=1)
    return TraceTables(
        tri=jnp.asarray(tri), ids=jnp.asarray(ids), page_box=jnp.asarray(box),
        bank_box=jnp.asarray(bank), num_pages=NP, bank_pages=G)


def _box(ref, i):
    """(lo, hi) scalar triples of row i of a [n, 8] AABB table."""
    return ([ref[i, k] for k in (0, 1, 2)], [ref[i, k] for k in (4, 5, 6)])


def _trace_kernel(o0_ref, o1_ref, o2_ref, d0_ref, d1_ref, d2_ref, live_ref,
                  excl_ref, bank_ref, tri_ref, ids_ref, box_ref, t_ref,
                  id_ref, *, bank_pages: int, num_pages: int, any_hit: bool):
    o3 = (o0_ref[...], o1_ref[...], o2_ref[...])
    d3 = (d0_ref[...], d1_ref[...], d2_ref[...])
    i3 = tuple(inv_dir(d) for d in d3)
    oc = tuple(v[:, None] for v in o3)
    dc = tuple(v[:, None] for v in d3)
    live = live_ref[...] != 0
    excl = excl_ref[...]
    num_banks = bank_ref.shape[0]
    slots = jnp.arange(_pow2(max(num_banks, 16)), dtype=jnp.int32)
    big_id = jnp.int32(np.iinfo(np.int32).max)

    def bank_bound(b, ent):
        """Level 1: the block's entry bound of bank b into slot b."""
        hit, entry = slab(o3, i3, *_box(bank_ref, b))
        e = jnp.min(jnp.where(hit & live, entry, INF))
        return jnp.where(slots == b, e, ent)

    def visit_page(p, need, carry):
        best_t, best_id = carry
        t, ok = hit_terms(lambda f: tri_ref[p, f, :][None, :], oc, dc)
        ids = ids_ref[p, :][None, :]
        ok = ok & need[:, None] & (ids != excl[:, None])
        tt = jnp.where(ok, t, INF)
        page_min = jnp.min(tt, axis=1)
        page_id = jnp.min(jnp.where(tt == page_min[:, None], ids, big_id),
                          axis=1)
        best_t, best_id = lex_update(best_t, best_id, page_min, page_id)
        if any_hit:
            best_t = jnp.where(best_id != 0, -INF, best_t)
        return best_t, best_id

    def bank_body(carry):
        ent, best_t, best_id = carry
        b = jnp.argmin(ent).astype(jnp.int32)
        ent = jnp.where(slots == b, INF, ent)

        def page_body(j, c):
            p = b * bank_pages + j
            hit, entry = slab(o3, i3, *_box(box_ref, p))
            need = hit & (entry <= c[0]) & (p < num_pages)
            return jax.lax.cond(
                jnp.max(need.astype(jnp.int32)) > 0,
                functools.partial(visit_page, p, need), lambda c_: c_, c)

        best_t, best_id = jax.lax.fori_loop(0, bank_pages, page_body,
                                            (best_t, best_id))
        return ent, best_t, best_id

    def more(carry):
        ent, best_t, _ = carry
        nxt = jnp.min(ent)
        return (nxt < INF) & (nxt <= jnp.max(best_t))

    # a block with no live ray (the compacted tail) skips even level 1
    ent = jnp.full(slots.shape, INF, F32)
    ent = jax.lax.cond(
        jnp.max(live.astype(jnp.int32)) > 0,
        lambda e: jax.lax.fori_loop(0, num_banks, bank_bound, e),
        lambda e: e, ent)
    best_t = jnp.where(live, INF, -INF)
    best_id = jnp.zeros_like(excl)
    _, best_t, best_id = jax.lax.while_loop(more, bank_body,
                                            (ent, best_t, best_id))
    t_ref[...] = jnp.where(live & (best_t >= 0.0), best_t, INF)
    id_ref[...] = best_id


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def trace_kernel(tables: TraceTables, o_t, d_t, live, excl=None,
                 any_hit: bool = False, interpret: bool = False):
    """Nearest (or any) hit for rays o_t, d_t [3, R], R a multiple of BLOCK;
    live [R] bool.  Returns (t [R] f32, id [R] int32)."""
    R = o_t.shape[1]
    NC = R // BLOCK
    excl = jnp.zeros((R,), jnp.int32) if excl is None \
        else excl.astype(jnp.int32)
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))
    tabs = (tables.bank_box, tables.tri, tables.ids, tables.page_box)
    whole = [pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)
             for a in tabs]
    kernel = functools.partial(_trace_kernel,
                               bank_pages=tables.bank_pages,
                               num_pages=tables.num_pages, any_hit=any_hit)
    return pl.pallas_call(
        kernel,
        grid=(NC,),
        in_specs=[ray] * 8 + whole,
        out_specs=[ray, ray],
        out_shape=[jax.ShapeDtypeStruct((R,), F32),
                   jax.ShapeDtypeStruct((R,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="trace_any_hit" if any_hit else "trace_nearest",
    )(*o_t.astype(F32), *d_t.astype(F32), live.astype(jnp.int32), excl,
      *tabs)


@functools.partial(jax.jit, static_argnames=("any_hit", "chunk"))
def trace_plain(tables: TraceTables, o_t, d_t, live, excl=None,
                any_hit: bool = False, chunk: int = 1024):
    """The same contract in plain XLA, with chunk-granular culling and early
    exit (see the module docstring).  R must be a multiple of `chunk`."""
    R = o_t.shape[1]
    NC = R // chunk
    mask, tmin = cull_mask_exact(o_t, d_t, live, tables.page_box[:, 0:3],
                                 tables.page_box[:, 4:7], chunk)
    order = jnp.argsort(tmin, axis=1).astype(jnp.int32)
    entry = jnp.sort(tmin, axis=1)                      # +inf past the list
    n_steps = jnp.max(jnp.sum(mask, axis=1))

    oc = tuple(o_t[k].reshape(NC, chunk, 1) for k in range(3))
    dc = tuple(d_t[k].reshape(NC, chunk, 1) for k in range(3))
    live_c = live.reshape(NC, chunk)
    excl_c = (jnp.zeros((NC, chunk), jnp.int32) if excl is None
              else excl.astype(jnp.int32).reshape(NC, chunk))
    big_id = jnp.int32(np.iinfo(np.int32).max)

    def active(k, best_t):
        e = jax.lax.dynamic_index_in_dim(entry, k, axis=1, keepdims=False)
        return e <= jnp.max(best_t, axis=1)             # [NC]; inf never

    def more(carry):
        k, best_t, _ = carry
        last = entry.shape[1] - 1
        return (k < n_steps) & jnp.any(active(jnp.minimum(k, last), best_t))

    def step(carry):
        k, best_t, best_id = carry
        go = active(k, best_t)
        p = jax.lax.dynamic_index_in_dim(order, k, axis=1, keepdims=False)
        feats = tables.tri[p]                           # [NC, 16, P2]
        ids = tables.ids[p][:, None, :]                 # [NC, 1, P2]
        t, ok = hit_terms(lambda f: feats[:, None, f, :], oc, dc)
        ok = ok & go[:, None, None] & (ids != excl_c[:, :, None])
        tt = jnp.where(ok, t, INF)
        page_min = jnp.min(tt, axis=2)
        page_id = jnp.min(jnp.where(tt == page_min[..., None], ids, big_id),
                          axis=2)
        best_t, best_id = lex_update(best_t, best_id, page_min, page_id)
        if any_hit:
            best_t = jnp.where(best_id != 0, -INF, best_t)
        return k + 1, best_t, best_id

    best_t = jnp.where(live_c, INF, -INF)
    _, best_t, best_id = jax.lax.while_loop(
        more, step, (jnp.int32(0), best_t, jnp.zeros_like(excl_c)))
    t = jnp.where(live_c & (best_t >= 0.0), best_t, INF)
    return t.reshape(R), best_id.reshape(R)


def trace(tables: TraceTables, o_t, d_t, live, excl=None,
          any_hit: bool = False, *, plain: bool = False,
          interpret: bool = False, chunk: int = 1024):
    """Dispatch to the kernel (default) or its plain-XLA version."""
    if plain:
        return trace_plain(tables, o_t, d_t, live, excl, any_hit=any_hit,
                           chunk=chunk)
    return trace_kernel(tables, o_t, d_t, live, excl, any_hit=any_hit,
                        interpret=interpret)
