"""Wavefront renderer: the portable, brute-force reference path.

The reference has two backends: a recursive per-thread CPU tracer
(`project_ray`/`color_ray`, raytrace_lib/src/raytrace.rs:1199-1295, driven by a
row work queue at :1168-1196) and a CUDA wavefront that only does primary rays
(cuda_raytrace.rs:277-515).  This design completes the wavefront: ALL
shading depths run as batched waves.

Recursion -> iteration: the recursive color algebra
    project(depth) = mix(c_surf, project(depth-1), alpha)
                   = c_surf*(1-alpha) + alpha*project(depth-1)
unrolls exactly into a running (accum, weight) pair folded over at most
`maxdepth` waves:
    scatter hit:  accum += weight * c_surf * (1-alpha);  weight *= alpha
    solid/edge:   accum += weight * c_surf;              ray retires
    miss:         accum += weight * SKY;                 ray retires
    depth out:    nothing added (project_ray depth==0 -> black,
                  raytrace.rs:1261-1263)
Each wave is one brute-force nearest-hit scan over every page for the whole
ray batch plus a masked shading/scatter step; bounce rays are written in
place and dead rays are masked.  The production path (engine.Engine) shares
`shade_active` but culls, traverses front to back and compacts.

Everything from camera ray generation to the final image is one jit program
per wave count; the scene lives on device as paged feature tables
(ops/pages.py) plus per-triangle shade tables gathered by hit id.
"""

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import math3d as m3
from .camera import Viewport
from .materials import KIND_MATTE, KIND_REFLECTIVE
from .ops.intersect_xla import nearest_hit_xla
from .ops.pages import PageTables, build_pages
from .scene import Scene

F32 = jnp.float32

SKY = jnp.asarray(m3.make_color((128, 180, 255)))   # CPU sky, raytrace.rs:1264
BLACK = jnp.zeros(3, dtype=F32)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["PK", "center", "norm", "sides", "side_lens",
                 "edge_thickness", "mat_kind", "mat_color", "mat_alpha",
                 "mat_scattering"],
    meta_fields=["page_size"])
@dataclass
class SceneTensors:
    """Device-resident scene: intersection pages + shade tables (jit pytree)."""

    PK: jax.Array           # [NP, P, 17] packed pages (ops/pages.py)
    page_size: int
    # per-triangle shade tables, gathered by hit id:
    center: jax.Array       # [N, 3]
    norm: jax.Array         # [N, 3]
    sides: jax.Array        # [N, 3, 3]
    side_lens: jax.Array    # [N, 3]
    edge_thickness: jax.Array  # [N]
    mat_kind: jax.Array     # [N] int32
    mat_color: jax.Array    # [N, 3]
    mat_alpha: jax.Array    # [N]
    mat_scattering: jax.Array  # [N]


def upload_scene(scene: Scene, page_size: int = 128,
                 pages: Optional[PageTables] = None) -> SceneTensors:
    pages = pages or build_pages(scene.tris, page_size=page_size)
    t = scene.tris
    return SceneTensors(
        PK=jnp.asarray(pages.PK),
        page_size=pages.page_size,
        center=jnp.asarray(t.incenter), norm=jnp.asarray(t.norm),
        sides=jnp.asarray(t.sides), side_lens=jnp.asarray(t.side_lens),
        edge_thickness=jnp.asarray(t.edge_thickness),
        mat_kind=jnp.asarray(t.materials.kind),
        mat_color=jnp.asarray(t.materials.color),
        mat_alpha=jnp.asarray(t.materials.alpha),
        mat_scattering=jnp.asarray(t.materials.scattering),
    )


def _unit(v):
    return v * jax.lax.rsqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def _random_unit_vec(key, shape):
    """`random_vec` (raytrace.rs:188-192): unit(uniform[-0.5,0.5]^3)."""
    v = jax.random.uniform(key, shape + (3,), dtype=F32) - F32(0.5)
    return _unit(v)


def shade_active(st: SceneTensors, o, d, t, hid, weight, valid, rv,
                 shadowed=None):
    """One wave of the color algebra over an active ray set.

    valid: rays that entered this wave alive (padding/dead rays are False and
    contribute nothing).  shadowed ([R] bool, optional) blacks out the
    surface color of occluded hits (the commented shadow design,
    raytrace.rs:1203-1224).  Returns (contrib [R,3], weight', alive', o',
    d'): contrib is this wave's addition to the pixel accumulator; alive'
    marks rays that scattered and continue.
    """
    miss = hid == 0

    center = st.center[hid]
    norm = st.norm[hid]
    sides = st.sides[hid]
    lens = st.side_lens[hid]
    et = st.edge_thickness[hid]
    kind = st.mat_kind[hid]
    color = st.mat_color[hid]
    alpha = st.mat_alpha[hid]
    scat = st.mat_scattering[hid]

    if shadowed is not None:
        color = jnp.where(shadowed[:, None], 0.0, color)

    point = o + t[:, None] * d
    ip = point - center
    # elementwise, not a matrix product: no backend may run it in TF32
    dist = (sides[..., 0] * ip[:, None, 0] + sides[..., 1] * ip[:, None, 1]
            + sides[..., 2] * ip[:, None, 2])
    # Edge band (Triangle::intersects, raytrace.rs:415-422) evaluated on the
    # winning triangle -> solid black wireframe (getsurface, raytrace.rs:450-460)
    edge = jnp.any(dist > lens * (F32(1.0) - et[:, None]), axis=-1)
    back = jnp.sum(d * norm, axis=-1) > 0          # raytrace.rs:424-436
    norm_f = jnp.where(back[:, None], -norm, norm)  # normal(), raytrace.rs:441-449

    is_scatter = (~miss) & (~edge) & ((kind == KIND_MATTE) |
                                      (kind == KIND_REFLECTIVE))
    is_terminal = valid & ~is_scatter

    surf_color = jnp.where(edge[:, None], BLACK, color)
    term_color = jnp.where(miss[:, None], SKY, surf_color)
    contrib = jnp.where(is_terminal[:, None], weight[:, None] * term_color, 0.0)

    scatter_live = valid & is_scatter
    contrib = contrib + jnp.where(
        scatter_live[:, None],
        weight[:, None] * color * (F32(1.0) - alpha[:, None]), 0.0)
    weight = jnp.where(scatter_live, weight * alpha, weight)

    # Bounce rays (lambertian_ray raytrace.rs:292-297; reflect_ray :278-290)
    matte_dir = _unit(norm_f + rv)
    matte_orig = point + rv * F32(0.001)
    ddot = jnp.abs(jnp.sum(d * norm_f, axis=-1, keepdims=True))
    refl_dir = _unit(d + 2.0 * norm_f * ddot + rv * scat[:, None])
    refl_orig = point + refl_dir * F32(0.001)

    is_matte = (kind == KIND_MATTE)[:, None]
    new_o = jnp.where(is_matte, matte_orig, refl_orig)
    new_d = jnp.where(is_matte, matte_dir, refl_dir)

    upd = scatter_live[:, None]
    o = jnp.where(upd, new_o, o)
    d = jnp.where(upd, new_d, d)
    return contrib, weight, scatter_live, o, d


def fixed_scatter(R: int):
    """The FixedRng scatter vector (oracle.FixedRng) for R rays."""
    return jnp.broadcast_to(_unit(jnp.asarray([0.36, 0.48, 0.8], dtype=F32)),
                            (R, 3))


def light_args(scene: Scene):
    """Device form of the scene's light for shadow_mask (None: no light)."""
    if scene.lights is None:
        return None
    return (jnp.asarray(scene.lights.orig, dtype=F32),
            jnp.asarray(scene.lights.len2, dtype=F32))


def shadow_mask(st: SceneTensors, trace_fn, o, d, t, hid, alive, key, wave,
                fixed_rng: bool, light):
    """Shadow feelers (commented reference design, raytrace.rs:600-610,
    1203-1224): a jittered ray to the light from each hit; shadowed if any
    OTHER triangle intersects it (origin triangle excluded by id, no
    distance limit — oracle.is_shadowed).

    trace_fn(o, d, live, excl=..., any_hit=True) -> (t, id) traces them.
    """
    light_orig, light_len2 = light
    R = o.shape[0]
    hit = alive & (hid != 0)
    point = o + jnp.where(hit, t, 0.0)[:, None] * d
    nrm = st.norm[hid]
    back = jnp.sum(d * nrm, axis=-1) > 0
    norm_f = jnp.where(back[:, None], -nrm, nrm)
    if fixed_rng:
        u3 = jnp.full((R, 3), 0.5, F32)
        u1 = jnp.full((R, 1), 0.5, F32)
    else:
        skey = jax.random.fold_in(key, 7_000_000 + wave)
        u3 = jax.random.uniform(jax.random.fold_in(skey, 0), (R, 3), F32)
        u1 = jax.random.uniform(jax.random.fold_in(skey, 1), (R, 1), F32)
    adj = light_orig[None, :] + u3 * light_len2
    sd = _unit(adj - point)
    so = point + norm_f * (F32(0.005) * (u1 + F32(1.0)))
    _, sid = trace_fn(jnp.where(hit[:, None], so, 0.0),
                      jnp.where(hit[:, None], sd, 0.0), hit,
                      excl=jnp.where(hit, hid, 0), any_hit=True)
    return hit & (sid != 0)


def _brute_force(st: SceneTensors):
    def trace_fn(o, d, live, excl=None, any_hit=False):
        # the nearest hit other than `excl` is a hit iff any other exists
        return nearest_hit_xla(o, d, st.PK, excl)
    return trace_fn


@functools.partial(jax.jit, static_argnames=("maxdepth", "fixed_rng"))
def trace_rays(st: SceneTensors, o, d, key, maxdepth: int,
               fixed_rng: bool = False, light=None):
    """Trace a ray batch to colors.  Returns (colors [R,3], aux dict).

    light: None or light_args(scene) for the shadow feelers.  aux carries
    per-ray primary hit id/t (the debug buffers of debug.rs) and the
    per-wave alive counts (the "Rays" stat of progress.rs/raytrace.rs:1278).
    """
    R = o.shape[0]
    accum = jnp.zeros((R, 3), dtype=F32)
    weight = jnp.ones((R,), dtype=F32)
    alive = jnp.ones((R,), dtype=bool)

    primary_t = None
    primary_id = None
    wave_rays = []

    for wave in range(maxdepth):
        wave_rays.append(jnp.sum(alive, dtype=jnp.int32))
        t, hid = nearest_hit_xla(o, d, st.PK)
        if wave == 0:
            primary_t, primary_id = t, hid
        if fixed_rng:
            rv = fixed_scatter(R)
        else:
            rv = _random_unit_vec(jax.random.fold_in(key, wave), (R,))
        shadowed = None
        if light is not None:
            shadowed = shadow_mask(st, _brute_force(st), o, d, t, hid, alive,
                                   key, wave, fixed_rng, light)
        contrib, weight, alive, o, d = shade_active(st, o, d, t, hid, weight,
                                                    alive, rv, shadowed)
        accum = accum + contrib
    # rays still alive after maxdepth waves would recurse at depth 0 -> black
    aux = {
        "primary_t": primary_t,
        "primary_id": primary_id,
        "wave_rays": jnp.stack(wave_rays),
    }
    return accum, aux


@dataclass
class RenderResult:
    image: np.ndarray          # [H, W, 3] f32
    rays_traced: int           # total project_ray-equivalent calls
    wave_rays: np.ndarray      # [maxdepth] per-wave live-ray counts
    primary_t: np.ndarray      # [H, W(,S)] primary hit times (debug buffer)
    primary_id: np.ndarray     # [H, W(,S)] primary hit ids (0 = miss)
    seconds: float = 0.0
    # candidate-set debug buffers (engine debug renders): per-pixel primary
    # chunk index + per-chunk surviving-triangle-id lists (debug.rs's
    # check_tris, recorded from the packet cull instead of an octree walk)
    primary_chunk: np.ndarray = None   # [H, W] int or None
    chunk_tris: list = None            # [NC] arrays of tri ids or None

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-12) / 1e6


class RayCaster:
    """Backend protocol (the `RayCaster` trait, raytrace.rs:1128-1165).

    The reference trait spawns the backend on a scoped thread and pumps an
    mpsc progress channel from the main thread; in the batched design a
    backend exposes `render(viewport, ...) -> RenderResult` and `walk_rays`
    wraps it with a ProgressCtx for name-compatible usage.
    """

    def render(self, v: Viewport, **kw) -> "RenderResult":   # pragma: no cover
        raise NotImplementedError

    def walk_rays(self, v: Viewport, show_progress: bool = False, **kw):
        """Reference-shaped entry point: renders and returns (result,
        ProgressCtx) with stats accumulated (walk_rays, raytrace.rs:1133-1163).
        """
        from .utils.progress import create_ctx

        ctx = create_ctx(v.width, v.height, enable_io=show_progress)
        result = self.render(v, progress=ctx, **kw)
        ctx.finish()
        return result, ctx


class WavefrontRenderer(RayCaster):
    """The simple full-batch RayCaster: brute force over every page, in
    plain XLA — the portable reference the engine is checked against."""

    def __init__(self, scene: Scene, page_size: int = 256,
                 slab_size: int = 1 << 20):
        self.slab_size = slab_size
        self.tensors = upload_scene(scene, page_size=page_size)
        self.scene = scene

    def render(self, v: Viewport, key: Optional[jax.Array] = None,
               fixed_rng: bool = False, progress=None) -> RenderResult:
        """Render the full image.

        Rays are processed in fixed-size slabs (a host-level loop over one jit
        program — the analog of the reference's row work queue,
        raytrace.rs:1181-1191): bounds per-wave temporary memory and keeps jit
        cache hits to at most two shapes (full slab + remainder).
        """
        import time

        key = key if key is not None else jax.random.PRNGKey(0)
        spp = v.samples_per_pixel
        t0 = time.perf_counter()

        o, d = _camera_rays_device(v, key, spp, fixed_rng)
        R = o.shape[0]
        S = self.slab_size
        # pad ray count to a multiple of the slab for a single program shape
        n_slabs = max(1, -(-R // S))
        if n_slabs == 1:
            S = R

        colors_parts, aux_parts = [], []
        for s in range(n_slabs):
            lo = s * S
            hi = min(R, lo + S)
            o_s, d_s = o[lo:hi], d[lo:hi]
            c, aux = trace_rays(self.tensors, o_s, d_s,
                                jax.random.fold_in(key, s),
                                maxdepth=v.maxdepth, fixed_rng=fixed_rng,
                                light=light_args(self.scene))
            colors_parts.append(c)
            aux_parts.append(aux)
            if progress is not None and n_slabs > 1:
                # per-slab live progress (the reference's per-row channel
                # reports, raytrace.rs:1429; flushed every 10k rays there)
                wr = np.asarray(aux["wave_rays"])
                progress.update((hi - lo) // spp,
                                {"Rays": int(wr.sum())})
                for i, n in enumerate(wr):
                    progress._stat(f"Wave{i}Rays", "count").add(int(n))

        colors = np.concatenate([np.asarray(c) for c in colors_parts])[:R]
        aux = {
            "primary_t": np.concatenate(
                [np.asarray(a["primary_t"]) for a in aux_parts])[:R],
            "primary_id": np.concatenate(
                [np.asarray(a["primary_id"]) for a in aux_parts])[:R],
            "wave_rays": np.stack(
                [np.asarray(a["wave_rays"]) for a in aux_parts]).sum(axis=0),
        }
        seconds = time.perf_counter() - t0

        img = np.asarray(colors, dtype=np.float32)
        if spp > 1:
            img = img.reshape(v.height, v.width, spp, 3).mean(axis=2)
            pid = np.asarray(aux["primary_id"]).reshape(v.height, v.width, spp)
            pt = np.asarray(aux["primary_t"]).reshape(v.height, v.width, spp)
        else:
            img = img.reshape(v.height, v.width, 3)
            pid = np.asarray(aux["primary_id"]).reshape(v.height, v.width)
            pt = np.asarray(aux["primary_t"]).reshape(v.height, v.width)

        wave_rays = np.asarray(aux["wave_rays"])
        result = RenderResult(
            image=img, rays_traced=int(wave_rays.sum()), wave_rays=wave_rays,
            primary_t=pt, primary_id=pid, seconds=seconds)
        if progress is not None and n_slabs == 1:
            # (with multiple slabs the per-slab loop already reported)
            progress.update_wavefront(result)
        return result

    def walk_one_ray(self, v: Viewport, px) -> RenderResult:
        """Single-pixel probe (Viewport::walk_one_ray, raytrace.rs:1442-1455)."""
        from .camera import pixel_rays

        row, col = px
        o, d = pixel_rays(v, np.asarray(row), np.asarray(col))
        o = jnp.asarray(o[None], dtype=F32)
        d = jnp.asarray(d[None], dtype=F32)
        colors, aux = trace_rays(self.tensors, o, d, jax.random.PRNGKey(0),
                                 maxdepth=v.maxdepth,
                                 light=light_args(self.scene))
        wave_rays = np.asarray(aux["wave_rays"])
        return RenderResult(
            image=np.asarray(colors).reshape(1, 1, 3),
            rays_traced=int(wave_rays.sum()), wave_rays=wave_rays,
            primary_t=np.asarray(aux["primary_t"]).reshape(1, 1),
            primary_id=np.asarray(aux["primary_id"]).reshape(1, 1))


@functools.partial(jax.jit, static_argnames=("width", "height", "spp",
                                             "fixed_rng"))
def _camera_rays_jit(orig, cam, vu, vv, key, *, width: int, height: int,
                     spp: int, fixed_rng: bool):
    H, W = height, width
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    rows = rows.reshape(-1).astype(F32)
    cols = cols.reshape(-1).astype(F32)

    rows_s = jnp.repeat(rows, spp) if spp > 1 else rows
    cols_s = jnp.repeat(cols, spp) if spp > 1 else cols
    if spp == 1 or fixed_rng:
        # pixel centers (raytrace.rs:1382-1386; oracle.FixedRng's 0.5)
        u_off = v_off = F32(0.5)
    else:
        u = jax.random.uniform(jax.random.fold_in(key, 1_000_001),
                               (H * W * spp,), dtype=F32)
        vj = jax.random.uniform(jax.random.fold_in(key, 1_000_002),
                                (H * W * spp,), dtype=F32)
        u_off, v_off = u, vj

    vu_delta = vu * (F32(1.0) / F32(W))
    vv_delta = vv * (F32(1.0) / F32(H))
    px_u = (orig + vu_delta * (cols_s + u_off)[:, None]
            + vv_delta * (rows_s + v_off)[:, None])
    d = _unit(px_u - cam)
    return px_u, d


def _camera_rays_device(v: Viewport, key, spp: int, fixed_rng: bool):
    return _camera_rays_jit(jnp.asarray(v.orig), jnp.asarray(v.cam),
                            jnp.asarray(v.vu), jnp.asarray(v.vv), key,
                            width=v.width, height=v.height, spp=spp,
                            fixed_rng=fixed_rng)
