"""Wavefront compaction in XLA.

The reference's workqueue retires finished rays and requeues survivors to
keep each cycle full (cuda_raytrace.rs:346-366, 444-456).  Here, after each
wave, live rays move to a prefix of the ray arrays by a stable partition:
a prefix sum gives every slot its new position and one scatter builds the
permutation.  Trace-kernel blocks past the live prefix hold no live ray and
exit at once.  Expansion (scatter back by the composed permutation) returns
each ray's result to its original position.
"""

import jax.numpy as jnp


def compact_order(alive):
    """order[i] = the slot whose ray moves to slot i: live rays first, then
    dead ones, each group in its previous order.  alive: [R] bool."""
    a = alive.astype(jnp.int32)
    n = jnp.sum(a)
    pos = jnp.where(alive, jnp.cumsum(a) - 1, n + jnp.cumsum(1 - a) - 1)
    return jnp.zeros_like(pos).at[pos].set(
        jnp.arange(a.shape[0], dtype=jnp.int32), unique_indices=True)


def compact(x, order):
    """Gather rows of x ([R, ...]) into compacted slot order."""
    return jnp.take(x, order, axis=0)


def expand(y, order):
    """Inverse of `compact`: row i of y returns to row order[i]."""
    return jnp.zeros_like(y).at[order].set(y, unique_indices=True)
