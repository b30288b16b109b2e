"""Production render engine: culled, front-to-back, compacted wavefront.

The reference's GPU workqueue architecture (cuda_raytrace_lib/src/
cuda_raytrace.rs:277-515), generalized to all shading depths:

  reference (per ray)                      this engine (per block of rays)
  -----------------------------------     --------------------------------------
  get_all_objects_for_ray: host octree     bank entry bounds per ray block, then
  walk -> ordered leaf tri lists           per-ray page slab tests in the
  (raytrace.rs:1052-1077)                  trace kernel (ops/trace.py)
  cycles of <=512 rays, best-hit carry     one kernel program per 64 rays,
  (cuda_raytrace.rs:340-504)               (t, id) winner kept in registers
  front-to-back early exit (disabled by    banks visited front to back; exit
  `|| true`, cuda_raytrace.rs:441)         once no bank can improve a ray
  per-cycle SoA repack + H2D upload        scene resident in device memory
  nextcycle requeue (:444-456)             survivors compacted to a prefix
                                           after every wave (ops/compact.py)

Shading gathers the winner's attributes by id in XLA (render.shade_active,
shared with the reference renderer).  A render is one jitted program: camera
rays, every wave, compaction and the final box filter and quantization.

Primary rays are emitted in square-tile order (index arithmetic, no
permutation) so a kernel block's rays are a coherent bundle and its entry
bounds are tight; the final image is un-permuted once on the host in numpy.
"""

import functools
import math
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .camera import Viewport
from .ops.compact import compact, compact_order, expand
from .ops.cull import cull_mask_exact
from .ops.pages import build_pages_kd
from .ops.trace import BLOCK, build_trace_tables, trace
from .render import (RayCaster, RenderResult, SceneTensors, _random_unit_vec,
                     _unit, fixed_scatter, light_args, shade_active,
                     shadow_mask, upload_scene)
from .scene import Scene

F32 = jnp.float32


def pick_tile(width: int, height: int) -> int:
    for t in (32, 16, 8):
        if width % t == 0 and height % t == 0:
            return t
    return 1


def tile_permutation(height: int, width: int, spp: int, tile: int) -> np.ndarray:
    """perm[q] = row-major ray index of tile-major position q (host side)."""
    rows = np.arange(height)
    cols = np.arange(width)
    order = []
    for tr in range(0, height, tile):
        for tc in range(0, width, tile):
            rr, cc = np.meshgrid(rows[tr:tr + tile], cols[tc:tc + tile],
                                 indexing="ij")
            order.append((rr * width + cc).reshape(-1))
    order = np.concatenate(order)
    if spp > 1:
        order = (order[:, None] * spp + np.arange(spp)[None, :]).reshape(-1)
    return order.astype(np.int64)


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds; Salmon et al., SC'11) on uint32 vectors.

    A counter-based PRNG evaluated per element: the output depends only on
    (key, counter), never on array shape or slicing — which is exactly what
    position-keyed camera jitter needs (see _pos_uniform).  Returns the
    first output word.
    """
    rot = (13, 15, 26, 6, 17, 29, 16, 24)
    k2 = k0 ^ k1 ^ jnp.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1

    def rotl(v, r):
        return (v << jnp.uint32(r)) | (v >> jnp.uint32(32 - r))

    for block in range(5):
        for r in range(4):
            x0 = x0 + x1
            x1 = rotl(x1, rot[(block % 2) * 4 + r])
            x1 = x1 ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + jnp.uint32(block + 1)
    return x0


def _pos_uniform(key, q, salt: int):
    """Uniform [0,1) f32 keyed by ABSOLUTE stream position q (uint32 vector).

    jax.random.uniform(key, (n,)) seeds its counter at the array's own
    index 0, so a band/shard drawing its slice of jitter would get values
    that depend on where the slice starts — banded renders could never be
    bit-equal to the full render at spp > 1 (raytrace.rs:1374-1394 draws
    jitter per pixel_ray call, which the row queue replays identically for
    any row split).  Hashing the absolute position through a counter-based
    threefry makes the draw a pure function of (key, salt, q): any window of
    the stream reproduces the full render's values bitwise.
    """
    kd = jax.random.key_data(jax.random.fold_in(key, salt))
    kd = kd.reshape(-1).astype(jnp.uint32)
    bits = _threefry2x32(kd[0], kd[1], q.astype(jnp.uint32),
                         jnp.zeros_like(q, dtype=jnp.uint32))
    # 24 high bits -> multiples of 2^-24 in [0, 1)
    return (bits >> jnp.uint32(8)).astype(F32) * F32(1.0 / (1 << 24))


@functools.partial(jax.jit, static_argnames=("width", "height", "spp", "tile",
                                             "n_pad", "q_base", "fixed_rng"))
def _camera_rays_tiled(orig, cam, vu, vv, key, *, width: int, height: int,
                       spp: int, tile: int, n_pad: int, q_base: int = 0,
                       fixed_rng: bool = False):
    """Primary rays emitted directly in tile-major order (pixel_ray semantics,
    raytrace.rs:1374-1394) — index arithmetic only, no permutation gathers.

    Returns (o, d) as [n_pad, 3]; positions beyond height*width*spp have
    d = 0 (invalid rays).  q_base: tile-major stream offset — rays for
    positions q_base..q_base+n_pad of the FULL image's stream (banded
    rendering: the same index arithmetic on absolute positions makes a
    band's rays bitwise identical to the full render's).  fixed_rng: every
    sample sits at the pixel center, like oracle.FixedRng's constant 0.5.
    """
    R0 = height * width * spp
    q = jnp.arange(n_pad) + q_base
    pix = q // spp if spp > 1 else q
    T = tile
    tpr = width // T
    tile_id = pix // (T * T)
    within = pix % (T * T)
    row = ((tile_id // tpr) * T + within // T).astype(F32)
    col = ((tile_id % tpr) * T + within % T).astype(F32)

    if spp == 1 or fixed_rng:
        u_off = v_off = F32(0.5)          # raytrace.rs:1382-1386
    else:
        # position-keyed jitter: a pure function of (key, absolute stream
        # position), so any band/shard window of the stream draws the SAME
        # values the full render does (bit-exact banding at spp > 1)
        u_off = _pos_uniform(key, q, 1_000_001)
        v_off = _pos_uniform(key, q, 1_000_002)

    vu_delta = vu * (F32(1.0) / F32(width))
    vv_delta = vv * (F32(1.0) / F32(height))
    px_u = (orig[None, :] + vu_delta[None, :] * (col + u_off)[:, None]
            + vv_delta[None, :] * (row + v_off)[:, None])       # [n_pad, 3]
    d = _unit(px_u - cam[None, :])
    live = (q < R0)[:, None]
    return jnp.where(live, px_u, 0.0), jnp.where(live, d, 0.0)


def _quantize_u8(img):
    """PNG writer's exact `(c*255) as u8` semantics (raytrace.rs:1470-1472)."""
    x = jnp.nan_to_num(img * F32(255.0), nan=0.0, posinf=255.0, neginf=0.0)
    return jnp.clip(jnp.trunc(x), 0.0, 255.0).astype(jnp.uint8)


def _device_quantizable(spp: int) -> bool:
    """True when on-device quantization is provably byte-equal to host
    quantization of the float render (the repo's PNG-semantics contract:
    u8 images == utils.png.quantize_u8(float image) always).

    Two float hazards make this spp-dependent:
      - division: XLA may compile _box_filter's `acc / spp` as a
        reciprocal multiply; 1/spp is exact in f32 only for powers of two
        (spp=3 measured a 1-step flip where mean*255 lands on an integer:
        host 164.99998 -> 164 vs device 165.0 -> 165);
      - association: the host float path averages with np.mean, whose
        summation is sequential only below numpy's 8-element unroll;
        _box_filter's explicit left-to-right chain matches it for spp < 8.
    Both hold exactly for spp in {1, 2, 4}; anything else renders float on
    device and quantizes on host (quantize=True still always returns u8).
    """
    return spp in (1, 2, 4)


def _box_filter(img, spp: int):
    """On-device box-filter sample average (raytrace.rs:1426) of [R, 3]
    samples, a pixel's spp samples adjacent, with an EXPLICIT left-to-right
    add chain instead of a reduce: XLA's `reduce` association order is
    implementation-defined, and a fixed chain matches np.mean's sequential
    summation on the host float path for spp < 8 (numpy unrolls to 8
    accumulators at 8+).  _device_quantizable gates device quantization to
    spp where the division is exact too."""
    s = img.reshape(-1, spp, 3)
    acc = s[:, 0]
    for i in range(1, spp):
        acc = acc + s[:, i]
    return acc / F32(spp)


@functools.partial(jax.jit,
                   static_argnames=("maxdepth", "chunk", "fixed_rng",
                                    "interpret", "plain", "want_primary",
                                    "quantize", "spp", "weight_cutoff",
                                    "compact_waves"))
def _render_device(st: SceneTensors, tables, o, d, alive0, key, light=None,
                   *, maxdepth: int, chunk: int, fixed_rng: bool,
                   interpret: bool, plain: bool, want_primary: bool,
                   quantize: bool, spp: int, weight_cutoff: float,
                   compact_waves: bool):
    """Full multi-wave render of padded tile-order rays o, d [R, 3].

    light: None or (orig [3], len2) for the shadow feelers.  Returns (img
    [R or R/spp, 3] in tile order — u8 when `quantize` — wave_counts
    [maxdepth], primary (t, id) or None, wave-0 candidate page mask
    [R/chunk, pages] or None).  Rays are independent, so under fixed_rng the
    image does not depend on compaction, on the chunking, or on which
    traversal runs.
    """
    R = o.shape[0]

    def trace_fn(o_, d_, live, excl=None, any_hit=False):
        return trace(tables, o_.T, d_.T, live, excl, any_hit, plain=plain,
                     interpret=interpret, chunk=chunk)

    src = jnp.arange(R, dtype=jnp.int32)      # original position of each slot
    accum = jnp.zeros((R, 3), F32)
    weight = jnp.ones((R,), F32)
    alive = alive0
    wave_counts = []
    primary = cand = None

    for wave in range(maxdepth):
        wave_counts.append(jnp.sum(alive, dtype=jnp.int32))
        t, hid = trace_fn(o, d, alive)
        if wave == 0 and want_primary:
            primary = (t, hid)
            cand, _ = cull_mask_exact(o.T, d.T, alive,
                                      tables.page_box[:, 0:3],
                                      tables.page_box[:, 4:7], chunk)
        if fixed_rng:
            rv = fixed_scatter(R)
        else:
            rv = _random_unit_vec(jax.random.fold_in(key, wave), (R,))
        shadowed = None
        if light is not None:
            shadowed = shadow_mask(st, trace_fn, o, d, t, hid, alive, key,
                                   wave, fixed_rng, light)
        contrib, weight, alive, o, d = shade_active(st, o, d, t, hid, weight,
                                                    alive, rv, shadowed)
        accum = accum + contrib
        if weight_cutoff > 0.0:
            # A ray's entire remaining contribution is bounded by its weight
            # (colors <= 1), so terminating below ~1/2 of a u8 quantization
            # step is visually lossless; 0.0 disables (exact mode).
            alive = alive & (weight > weight_cutoff)
        if compact_waves and wave < maxdepth - 1:
            order = compact_order(alive)
            o, d, weight, accum, src, alive = (
                compact(x, order) for x in (o, d, weight, accum, src, alive))

    img = expand(accum, src)
    if quantize:
        if spp > 1:
            img = _box_filter(img, spp)
        img = _quantize_u8(img)
    return img, jnp.stack(wave_counts), primary, cand


def _assemble_host_image(img_dev, v: Viewport, perm: np.ndarray, spp: int,
                         dev_quant: bool, want_u8: bool = False) -> np.ndarray:
    """Un-permute a device framebuffer (tile order, [R, 3] or [R//spp, 3])
    into the [height, width, 3] image with host numpy fancy indexing.

    dev_quant: the device already box-filtered + quantized (u8 input).
    want_u8: quantize=True was requested but the device rendered float
    (non-power-of-two spp, where device quantization is not byte-equal to
    the host contract — _device_quantizable): average + quantize here.
    """
    if dev_quant:
        P0 = v.height * v.width
        data = np.asarray(img_dev)[:P0]              # [P0, 3] u8
        pixperm = perm[::spp] // spp if spp > 1 else perm
        img = np.empty((P0, 3), dtype=np.uint8)
        img[pixperm] = data
        return img.reshape(v.height, v.width, 3)
    R0 = v.height * v.width * spp
    data = np.asarray(img_dev, dtype=np.float32)[:R0]
    img = np.empty((R0, 3), dtype=np.float32)
    img[perm] = data
    if spp > 1:
        img = img.reshape(v.height, v.width, spp, 3).mean(axis=2)
    else:
        img = img.reshape(v.height, v.width, 3)
    if want_u8:
        from .utils.png import quantize_u8
        img = quantize_u8(img)
    return img


class Engine(RayCaster):
    """Culled wavefront renderer (the performance path).

    Produces the same image as render.WavefrontRenderer: the traversal
    returns the brute-force (t, id) winner, the shading algebra is shared,
    and compaction only moves rays between slots.

    trace: "kernel" runs the GPU trace kernel (ops/trace.trace_kernel;
    `interpret=True` runs it in the Pallas interpreter on the CPU), "xla"
    the same traversal in plain XLA (ops/trace.trace_plain), the reference
    it is checked and timed against.  ray_chunk: padding quantum and the
    plain traversal's cull chunk; a multiple of the kernel's ray block.
    """

    def __init__(self, scene: Scene, page_size: int = 64,
                 ray_chunk: int = 1024, interpret: bool = False,
                 trace: str = "kernel", weight_cutoff: float = 1 / 512,
                 compact: bool = True):
        if trace not in ("kernel", "xla"):
            raise ValueError(f"trace must be 'kernel' or 'xla', not {trace!r}")
        if ray_chunk % BLOCK:
            raise ValueError(f"ray_chunk {ray_chunk} must be a multiple of "
                             f"the kernel's {BLOCK}-ray block")
        self.scene = scene
        self.page_size = page_size
        self.ray_chunk = ray_chunk
        self.interpret = interpret
        self.plain = trace == "xla"
        self.weight_cutoff = weight_cutoff
        self.compact = compact
        self.pages = build_pages_kd(scene.tris, page_size=page_size)
        self.tensors = upload_scene(scene, pages=self.pages)
        self.tables = build_trace_tables(self.pages)
        self._perm_cache = {}

    def _perm(self, v: Viewport, tile: int) -> np.ndarray:
        key = (v.height, v.width, v.samples_per_pixel, tile)
        if key not in self._perm_cache:
            self._perm_cache[key] = tile_permutation(
                v.height, v.width, v.samples_per_pixel, tile)
        return self._perm_cache[key]

    def _statics(self, v: Viewport, *, fixed_rng: bool, debug: bool,
                 quant: bool, spp: int, chunk: Optional[int] = None) -> dict:
        return dict(
            maxdepth=v.maxdepth, chunk=chunk or self.ray_chunk,
            fixed_rng=fixed_rng, interpret=self.interpret, plain=self.plain,
            want_primary=debug, quantize=quant, spp=spp,
            weight_cutoff=0.0 if fixed_rng else self.weight_cutoff,
            compact_waves=self.compact)

    def _quantum(self, spp: int) -> int:
        # whole chunks of rays, and whole sample groups per chunk boundary
        return self.ray_chunk * spp // math.gcd(self.ray_chunk, spp)

    def _primary_rays(self, v: Viewport, key, n_pad: int, fixed_rng: bool,
                      q_base: int = 0):
        tile = pick_tile(v.width, v.height)
        return _camera_rays_tiled(
            jnp.asarray(v.orig), jnp.asarray(v.cam), jnp.asarray(v.vu),
            jnp.asarray(v.vv), key, width=v.width, height=v.height,
            spp=v.samples_per_pixel, tile=tile, n_pad=n_pad, q_base=q_base,
            fixed_rng=fixed_rng)

    def _debug_buffers(self, v: Viewport, perm, R0: int, primary, cand):
        """Per-pixel primary hit t/id (the debug.rs trace buffers) and, for
        spp == 1, each pixel's primary chunk and the chunk's candidate
        triangles (the reference records the same sets inside its traversal,
        raytrace.rs:1018-1021)."""
        spp = v.samples_per_pixel
        pt = np.empty(R0, dtype=np.float32)
        pid = np.empty(R0, dtype=np.int32)
        pt[perm] = np.asarray(primary[0])[:R0]
        pid[perm] = np.asarray(primary[1])[:R0]
        shape = (v.height, v.width, spp) if spp > 1 else (v.height, v.width)
        primary_chunk = chunk_tris = None
        if cand is not None and spp == 1:
            mask = np.asarray(cand)
            page_ids = np.asarray(self.tables.ids)
            chunk_tris = []
            for c in range(mask.shape[0]):
                ids = page_ids[mask[c]].ravel()
                chunk_tris.append(np.unique(ids[ids > 0]))
            qpos = np.empty(R0, dtype=np.int64)
            qpos[perm] = np.arange(R0)
            primary_chunk = (qpos // self.ray_chunk).reshape(v.height,
                                                             v.width)
        return pt.reshape(shape), pid.reshape(shape), primary_chunk, chunk_tris

    def render(self, v: Viewport, key: Optional[jax.Array] = None,
               fixed_rng: bool = False, progress=None, debug: bool = False,
               quantize: bool = True) -> RenderResult:
        """Render.  `debug` additionally returns the per-pixel primary hit
        id/t buffers (the debug.rs trace buffers) and candidate sets;
        `quantize` returns a u8 image quantized on device (exact PNG
        semantics, 4x smaller transfer) — pass False for float images
        (oracle comparisons, custom tone mapping).
        """
        key = key if key is not None else jax.random.PRNGKey(0)
        spp = v.samples_per_pixel
        t0 = time.perf_counter()

        R0 = v.height * v.width * spp
        quantum = self._quantum(spp)
        R = -(-R0 // quantum) * quantum
        # device quantization only when byte-equal to the host contract
        quant = quantize and _device_quantizable(spp)

        o, d = self._primary_rays(v, key, R, fixed_rng)
        alive0 = jnp.arange(R) < R0
        img_dev, wave_counts, primary, cand = _render_device(
            self.tensors, self.tables, o, d, alive0, key,
            light_args(self.scene),
            **self._statics(v, fixed_rng=fixed_rng, debug=debug, quant=quant,
                            spp=spp))

        perm = self._perm(v, pick_tile(v.width, v.height))
        img = _assemble_host_image(img_dev, v, perm, spp, quant,
                                   want_u8=quantize and not quant)
        pt = pid = primary_chunk = chunk_tris = None
        if debug:
            pt, pid, primary_chunk, chunk_tris = self._debug_buffers(
                v, perm, R0, primary, cand)
        wave_counts = np.asarray(wave_counts)
        result = RenderResult(
            image=img, rays_traced=int(wave_counts.sum()),
            wave_rays=wave_counts, primary_t=pt, primary_id=pid,
            seconds=time.perf_counter() - t0, primary_chunk=primary_chunk,
            chunk_tris=chunk_tris)
        if progress is not None:
            progress.update_wavefront(result)
        return result

    def render_sharded(self, v: Viewport, mesh=None,
                       n_devices: Optional[int] = None,
                       key: Optional[jax.Array] = None,
                       fixed_rng: bool = False, progress=None,
                       debug: bool = False,
                       quantize: bool = True) -> RenderResult:
        """Multi-device render: the per-device program of render(),
        data-parallel over a 1-D image-tile mesh
        (parallel/sharding.engine_render_sharded) — the analog of the
        reference's N-worker row queue (raytrace.rs:1181-1191).  Under
        `fixed_rng` the assembled image equals render()'s; with live RNG
        each device folds its mesh position into the key for a decorrelated
        stream.  `debug` returns the per-pixel primary hit t/id buffers.
        """
        from jax.sharding import NamedSharding, PartitionSpec
        from .parallel.sharding import (TILE_AXIS, engine_render_sharded,
                                        make_mesh)

        if mesh is None:
            mesh = make_mesh(n_devices)
        n = mesh.shape[TILE_AXIS]
        key = key if key is not None else jax.random.PRNGKey(0)
        spp = v.samples_per_pixel
        t0 = time.perf_counter()

        R0 = v.height * v.width * spp
        quantum = n * self._quantum(spp)
        R = -(-R0 // quantum) * quantum
        quant = quantize and _device_quantizable(spp)

        o, d = self._primary_rays(v, key, R, fixed_rng)
        alive0 = jnp.arange(R) < R0
        rows = NamedSharding(mesh, PartitionSpec(TILE_AXIS))
        img_dev, wave_counts, primary = engine_render_sharded(
            self, jax.device_put(o, rows), jax.device_put(d, rows),
            jax.device_put(alive0, rows), key, mesh,
            **self._statics(v, fixed_rng=fixed_rng, debug=debug, quant=quant,
                            spp=spp))

        perm = self._perm(v, pick_tile(v.width, v.height))
        img = _assemble_host_image(img_dev, v, perm, spp, quant,
                                   want_u8=quantize and not quant)
        pt = pid = None
        if debug:
            pt, pid, _, _ = self._debug_buffers(v, perm, R0, primary, None)
        wave_counts = np.asarray(wave_counts)
        result = RenderResult(
            image=img, rays_traced=int(wave_counts.sum()),
            wave_rays=wave_counts, primary_t=pt, primary_id=pid,
            seconds=time.perf_counter() - t0)
        if progress is not None:
            progress.update_wavefront(result)
        return result

    def render_banded(self, v: Viewport, key: Optional[jax.Array] = None,
                      fixed_rng: bool = False, band_rows: Optional[int] = None,
                      max_band_rays: int = 4_194_304, progress=None,
                      quantize: bool = True) -> RenderResult:
        """Render in horizontal bands so device memory is bounded by the
        band, not the image — the analog of the reference's row work queue
        (raytrace.rs:1181-1191), which streams rows and never holds the full
        ray set.

        Each band's rays are the SAME tile-major stream positions the full
        render would emit (index arithmetic on absolute positions —
        _camera_rays_tiled q_base; at spp > 1 the camera jitter is
        position-keyed the same way, _pos_uniform), so under fixed_rng the
        banded image equals render()'s for any band split at ANY spp.  With
        live RNG each band folds its index into the SCATTER key
        (decorrelated bounce streams) while the camera jitter still matches
        the full render's.  Bands of equal padded size share one compiled
        executable.

        band_rows: rows per band (multiple of the pixel tile); default
        sizes bands to <= max_band_rays rays each.
        """
        key = key if key is not None else jax.random.PRNGKey(0)
        spp = v.samples_per_pixel
        t0 = time.perf_counter()

        tile = pick_tile(v.width, v.height)
        rays_per_row = v.width * spp
        if band_rows is None:
            band_rows = max(max_band_rays // rays_per_row, tile)
            band_rows -= band_rows % tile
        if band_rows <= 0 or band_rows % tile:
            raise ValueError(
                f"band_rows must be a positive multiple of the {tile}-px tile")
        band_rows = min(band_rows, v.height)

        quantum = self._quantum(spp)
        quant = quantize and _device_quantizable(spp)
        perm_full = self._perm(v, tile)
        out = np.empty((v.height, v.width, 3),
                       dtype=np.uint8 if quantize else np.float32)
        wave_counts = None
        rays = 0
        for bi, r0 in enumerate(range(0, v.height, band_rows)):
            bh = min(band_rows, v.height - r0)
            q0 = r0 * rays_per_row
            Rb0 = bh * rays_per_row
            Rpad = -(-Rb0 // quantum) * quantum
            # scatter key: per-band fold (live-RNG decorrelation; inert
            # under fixed_rng).  Camera jitter uses the BASE key — it is
            # position-keyed (_pos_uniform), so every band draws exactly
            # the full render's values for its stream window.
            kb = jax.random.fold_in(key, bi)
            o, d = self._primary_rays(v, key, Rpad, fixed_rng, q_base=q0)
            alive0 = jnp.arange(Rpad) < Rb0
            img_dev, wc, _, _ = _render_device(
                self.tensors, self.tables, o, d, alive0, kb,
                light_args(self.scene),
                **self._statics(v, fixed_rng=fixed_rng, debug=False,
                                quant=quant, spp=spp))
            band_view = type("BandView", (), {"height": bh,
                                              "width": v.width})()
            perm_local = perm_full[q0:q0 + Rb0] - q0
            out[r0:r0 + bh] = _assemble_host_image(
                img_dev, band_view, perm_local, spp, quant,
                want_u8=quantize and not quant)
            wc = np.asarray(wc)
            wave_counts = wc if wave_counts is None else wave_counts + wc
            rays += int(wc.sum())
            if progress is not None:
                # per-band progress report, like the reference's per-row
                # worker flushes (raytrace.rs:1411-1429)
                progress.update(bh * v.width, {"Rays": int(wc.sum())})

        result = RenderResult(
            image=out, rays_traced=rays, wave_rays=wave_counts,
            primary_t=None, primary_id=None,
            seconds=time.perf_counter() - t0)
        if progress is not None:
            for i, n in enumerate(wave_counts):
                progress._stat(f"Wave{i}Rays", "count").add(int(n))
        return result

    def walk_one_ray(self, v: Viewport, px,
                     key: Optional[jax.Array] = None,
                     fixed_rng: bool = True) -> RenderResult:
        """Single-pixel probe (Viewport::walk_one_ray, raytrace.rs:1442-1455;
        the CUDA cast_one_ray analog) through the PRODUCTION pipeline: the
        one ray rides slot 0 of one kernel block through the same trace,
        shade and compaction code as a full render — including the scene's
        shadow feelers when lights are set.  Under fixed_rng (the default)
        the probed pixel equals render()'s bitwise (per-ray values are
        independent of grouping).
        """
        from .camera import pixel_rays

        row, col = px
        key = key if key is not None else jax.random.PRNGKey(0)
        o_np, d_np = pixel_rays(v, np.asarray(row), np.asarray(col))
        R = BLOCK
        o = jnp.zeros((R, 3), F32).at[0].set(jnp.asarray(o_np, dtype=F32))
        d = jnp.zeros((R, 3), F32).at[0].set(jnp.asarray(d_np, dtype=F32))
        alive0 = jnp.arange(R) < 1
        img, wave_counts, primary, _ = _render_device(
            self.tensors, self.tables, o, d, alive0, key,
            light_args(self.scene),
            **self._statics(v, fixed_rng=fixed_rng, debug=True, quant=False,
                            spp=1, chunk=R))
        wave_rays = np.asarray(wave_counts)
        return RenderResult(
            image=np.asarray(img)[0].reshape(1, 1, 3),
            rays_traced=int(wave_rays.sum()), wave_rays=wave_rays,
            primary_t=np.asarray(primary[0])[0].reshape(1, 1),
            primary_id=np.asarray(primary[1])[0].astype(np.int32).reshape(1,
                                                                          1))
