"""Pure-XLA brute-force nearest-hit: lax.scan over every page with a
running minimum.

The portable implementation of the kernel contract (see intersect_ref.py),
used by the reference renderer (render.WavefrontRenderer).  Structure mirrors
the reference GPU cycle loop (`cuda_raytrace.rs:340-504`): a fixed-shape page
per step and a best hit carried between steps, with the scene resident on
device.  It tests every ray against every triangle, so it is a reference,
not a production path.
"""

import jax
import jax.numpy as jnp

from .pages import LANE_ID
from .trace import hit_terms

F32 = jnp.float32


def nearest_hit_xla(O, D, PK, excl=None):
    """O, D: [R, 3] f32.  PK: [NP, P, lanes] packed pages (ops/pages.py).
    excl: optional [R] triangle id per ray that cannot hit (0: none).

    Returns (best_t [R] f32 with +inf misses, best_id [R] int32, 0 = miss).
    """
    O = O.astype(F32)
    D = D.astype(F32)
    if excl is not None:
        excl = excl.astype(F32)
    o3 = tuple(O[None, :, k] for k in range(3))          # [1, R]
    d3 = tuple(D[None, :, k] for k in range(3))

    # Derive the scan init from the inputs (not fresh zeros) so it inherits
    # their sharding/varying axes under shard_map.
    init = (jnp.full_like(O[:, 0], jnp.inf), jnp.zeros_like(O[:, 0]))

    def step(carry, pk):
        best_t, best_id = carry                          # [R]
        t, valid = hit_terms(lambda f: pk[:, f:f + 1], o3, d3)   # [P, R]
        if excl is not None:
            valid = valid & (pk[:, LANE_ID:LANE_ID + 1] != excl[None, :])
        tt = jnp.where(valid, t, jnp.inf)

        page_min = tt.min(axis=0)                                   # [R]
        ids = jnp.where(tt == page_min[None, :],
                        pk[:, LANE_ID:LANE_ID + 1], jnp.inf).min(axis=0)
        upd = page_min < best_t
        return (jnp.where(upd, page_min, best_t),
                jnp.where(upd, ids, best_id)), None

    (best_t, best_id), _ = jax.lax.scan(step, init, PK)
    return best_t, best_id.astype(jnp.int32)
