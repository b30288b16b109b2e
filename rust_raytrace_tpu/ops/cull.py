"""Ray/AABB slab tests and the (ray chunk) x (page AABB) cull.

Replacement for the reference's per-ray octree query
`get_all_objects_for_ray` (raytrace.rs:1052-1077), which walks the tree on the
host for EVERY ray to build its ordered page list — fine for 64x64 images,
hopeless for 3.7M rays/wave.  `slab` is the per-ray test the trace kernel
runs against bank and page boxes; `cull_mask_exact` reduces it over chunks
of rays for the plain-XLA traversal and the engine's debug candidate sets.

Both are CONSERVATIVE: the page boxes are inflated (ops/trace.BOX_PAD), so a
page holding a ray's hit always passes and its entry bound never exceeds the
hit distance; false positives only cost compute.
"""

import jax
import jax.numpy as jnp

F32 = jnp.float32
INF = jnp.inf


def inv_dir(d):
    """Slab-test reciprocal; a zero component maps to a huge finite value
    (0 * inf would be NaN), which keeps the test conservative."""
    return jnp.where(d == 0.0, F32(1e30), 1.0 / d)


def slab(o3, i3, lo3, hi3):
    """Ray/AABB slab interval: (hit, entry) with entry = max(t_lo, 0)."""
    tlo = thi = None
    for o, i, lo, hi in zip(o3, i3, lo3, hi3):
        t1 = (lo - o) * i
        t2 = (hi - o) * i
        a, b = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
        tlo = a if tlo is None else jnp.maximum(tlo, a)
        thi = b if thi is None else jnp.minimum(thi, b)
    return (tlo <= thi) & (thi >= 0.0), jnp.maximum(tlo, 0.0)


def cull_mask_exact(ot, dt, valid, blo, bhi, ray_chunk: int,
                    group: int = 64):
    """Exact per-ray slab tests, OR/min-reduced per chunk: the tightest
    chunk x page mask and each chunk's least entry distance per page.

    ot, dt: [3, R]; valid: [R]; blo/bhi: [NP, 3] (empty pages: lo = +inf,
    hi = -inf, never hit).  Pages are processed `group` at a time so the
    [chunk, ray, page] temporaries stay bounded whatever XLA fuses.
    Returns ([NC, NP] bool, [NC, NP] f32 with +inf where not hit).
    """
    R = ot.shape[1]
    NC = R // ray_chunk
    NP = blo.shape[0]
    # rays on the minor axis: the per-chunk reduction is a row reduction
    o3 = tuple(ot[k].reshape(NC, 1, ray_chunk) for k in range(3))
    i3 = tuple(inv_dir(dt[k]).reshape(NC, 1, ray_chunk) for k in range(3))
    v = valid.reshape(NC, 1, ray_chunk)
    pad = -NP % group
    lo = jnp.pad(blo, ((0, pad), (0, 0)), constant_values=INF)
    hi = jnp.pad(bhi, ((0, pad), (0, 0)), constant_values=-INF)

    def one_group(box):
        glo, ghi = box                                # [group, 3] each
        hit, entry = slab(o3, i3, tuple(glo[:, k:k + 1] for k in range(3)),
                          tuple(ghi[:, k:k + 1] for k in range(3)))
        hit = hit & v & (glo[:, 0:1] < INF)
        return jnp.min(jnp.where(hit, entry, INF), axis=2)   # [NC, group]

    tmin = jax.lax.map(one_group, (lo.reshape(-1, group, 3),
                                   hi.reshape(-1, group, 3)))
    tmin = jnp.moveaxis(tmin, 0, 1).reshape(NC, -1)[:, :NP]
    return tmin < INF, tmin
