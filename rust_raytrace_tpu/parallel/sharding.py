"""Multi-device image-tile data parallelism (Mesh + shard_map).

The reference parallelizes over image rows with a mutex-guarded work queue and
N CPU threads (raytrace.rs:1181-1191).  Rays are independent, so the scale-out
is pure data parallelism over a 1-D device mesh: the ray batch is sharded on a
"tiles" axis, the scene tables are replicated, and each device runs the
identical wavefront program on its shard.  The only collectives are a `psum`
of the per-wave ray counters (the "Rays" stat, raytrace.rs:1278) and the
gather of the sharded framebuffer when the host reads it.  The mesh is 1-D
because every device reaches every other at the same rate (NVLink joins the
cards of a host all to all).
"""

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render import SceneTensors, light_args, trace_rays

TILE_AXIS = "tiles"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D tile mesh over the first n devices of the default backend."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices, the {devices[0].platform} backend has "
            f"{len(devices)}: run on a host with {n} GPUs, or for a CPU "
            "rehearsal start Python with JAX_PLATFORMS=cpu and "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n}")
    return Mesh(np.asarray(devices[:n]), (TILE_AXIS,))


def trace_rays_sharded(st: SceneTensors, o, d, key, mesh: Mesh,
                       maxdepth: int, fixed_rng: bool = False):
    """One full reference-wavefront render, sharded over image tiles.

    o, d: [R, 3] with R divisible by mesh size.  Returns (colors [R, 3],
    wave_rays [maxdepth]) where wave_rays is the psum across devices.
    """
    n = mesh.shape[TILE_AXIS]
    R = o.shape[0]
    if R % n:
        raise ValueError(f"ray count {R} not divisible by mesh size {n}")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS), P()),
        out_specs=(P(TILE_AXIS), P()),
    )
    def step(st_rep, o_sh, d_sh, key_rep):
        # Decorrelate per-device RNG streams: a replicated key would give
        # every device the identical scatter-jitter sequence for its local
        # ray indices (visible as noise patterns repeating across tiles).
        key_sh = jax.random.fold_in(key_rep, jax.lax.axis_index(TILE_AXIS))
        colors, aux = trace_rays(st_rep, o_sh, d_sh, key_sh,
                                 maxdepth=maxdepth, fixed_rng=fixed_rng)
        wave_rays = jax.lax.psum(aux["wave_rays"], TILE_AXIS)
        return colors, wave_rays

    return step(st, o, d, key)


def shard_rays(o, d, mesh: Mesh):
    """Place ray arrays with tile sharding (device_put with NamedSharding)."""
    sharding = NamedSharding(mesh, P(TILE_AXIS))
    return jax.device_put(o, sharding), jax.device_put(d, sharding)


def engine_render_sharded(engine, o, d, alive, key, mesh: Mesh, **statics):
    """The engine's full multi-wave render, sharded over devices.

    o, d: [R, 3] tile-order rays and alive [R], R divisible by the mesh size
    times the engine's ray chunk.  `statics` are engine._render_device's
    static arguments.  Each device runs the complete pipeline (trace, shade,
    compaction) on its ray shard; under fixed_rng the assembled image equals
    the unsharded render's, because every per-ray value is independent of
    which rays share its device.  A pixel's spp samples are adjacent in tile
    order and the per-shard ray count is a multiple of spp, so no sample
    group straddles two devices.

    Returns (img [R or R/spp, 3] sharded, wave_counts [maxdepth] global,
    primary (t, id) sharded or None).
    """
    n = mesh.shape[TILE_AXIS]
    R = o.shape[0]
    if R % (n * engine.ray_chunk) or (R // n) % statics["spp"]:
        raise ValueError(f"ray count {R} does not split into whole chunks "
                         f"and sample groups over {n} devices")
    out = _sharded_render(engine.tensors, engine.tables, o, d, alive, key,
                          light_args(engine.scene), mesh=mesh,
                          statics=tuple(sorted(statics.items())))
    return out if statics["want_primary"] else out + (None,)


@functools.partial(jax.jit, static_argnames=("mesh", "statics"))
def _sharded_render(st, tables, o, d, alive, key, light, *, mesh: Mesh,
                    statics: tuple):
    from ..engine import _render_device

    statics = dict(statics)
    want_primary = statics["want_primary"]
    primary_spec = ((P(TILE_AXIS), P(TILE_AXIS)),) if want_primary else ()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS), P(),
                  P()),
        out_specs=(P(TILE_AXIS), P()) + primary_spec,
        # pallas_call out_shapes carry no varying-mesh-axes metadata
        check_vma=False,
    )
    def step(st, tables, o_sh, d_sh, alive_sh, key_rep, light_rep):
        # Decorrelated per-device streams with live RNG; under fixed_rng the
        # scatter vectors are constants, so the fold_in is inert.
        key_sh = jax.random.fold_in(key_rep, jax.lax.axis_index(TILE_AXIS))
        img, wave_counts, primary, _ = _render_device(
            st, tables, o_sh, d_sh, alive_sh, key_sh, light_rep, **statics)
        out = (img, jax.lax.psum(wave_counts, TILE_AXIS))
        return out + ((primary,) if want_primary else ())

    return step(st, tables, o, d, alive, key, light)
