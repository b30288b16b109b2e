"""Smoke test of the render engine on an NVIDIA GPU.

    python chip_smoke.py               # one GPU: phases 1-3
    python chip_smoke.py --four-cards  # four GPUs of one host: phase 4 only

Phases, each printed with what it ran, its rays, seconds, compile seconds,
peak device memory and every comparison beside its tolerance:

  1. device check: JAX's first device must be a GPU;
  2. the trace kernel at real widths, on circles_2k and the 1M-triangle
     sphere: against the numpy contract model (ops/intersect_ref.py) on
     1,024 sampled primary and 1,024 bounce rays, against the plain-XLA
     traversal on all 3,686,400 primary rays, and in any-hit mode against
     the plain-XLA any-hit on the bounce rays;
  3. Engine.render at 2560x1440, maxdepth 5 (circles, the 99.9k and 1M
     spheres, lit circles) and 512x512 at 4 spp (circles), each under
     fixed_rng against the engine's plain-XLA traversal at full size and
     against the brute-force WavefrontRenderer at a small size; then the
     CLI once, against Engine.render of the same scene and key;
  4. (--four-cards) Engine.render_sharded over four GPUs against one-GPU
     Engine.render, on circles_2k and the 1M sphere.

Tolerances, and why:
  - trace ids agree on >= 99.99% of rays: the kernel and XLA contract the
    predicate's multiply-adds differently, which flips the few predicates
    that sit exactly on a triangle edge;
  - where ids agree, |dt| <= 1e-5 (t + |o|): t = (n.c - n.o) / n.d
    subtracts terms the size of the ray origin o, so its rounding error
    scales with |o|, not with t (bounce rays hit neighbouring facets at
    t ~ 1e-5, where a bound relative to t alone would fail on rounding);
  - against the numpy model, at most 1 of 1,024 sampled ids may differ:
    a sample this small cannot resolve 0.01%, and numpy evaluates the dot
    products by BLAS with yet another rounding;
  - images: at most 0.05% of u8 pixels differ.  One flipped primary
    predicate changes one pixel; a flipped bounce predicate changes the
    pixel it belongs to, so the pixel share follows the predicate share.

The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed.  Any failure exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ID_AGREE = 0.9999       # share of rays whose trace ids must agree
REL_DT = 1e-5           # |dt| / (t + |o|) where ids agree
SAMPLE_MISMATCH = 1     # ids allowed to differ in a 1,024-ray model sample
PIXEL_DIFF = 0.0005     # share of u8 pixels allowed to differ
SAMPLE = 1024

_failures = []
_START = time.perf_counter()
_built = {}


def scene_of(name, build):
    """Each scene is built once and shared by the phases."""
    if name not in _built:
        _built[name] = build()
    return _built[name]


def engine_of(name, build, trace="kernel"):
    """One Engine per scene and traversal, shared by the phases."""
    from rust_raytrace_tpu.engine import Engine

    key = (name, trace)
    if key not in _built:
        _built[key] = Engine(scene_of(name, build)[0], trace=trace)
    return _built[key]


def check(name: str, value, limit: str, ok: bool) -> None:
    print(f"    {name}: {value}  (limit {limit})  {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        _failures.append(name)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peak_bytes() -> int:
    import jax
    return max(d.memory_stats()["peak_bytes_in_use"]
               for d in jax.local_devices())


def timed(fn):
    """(result, steady seconds, compile seconds): the first call compiles,
    the second is timed; both end with the result on the host."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    steady = time.perf_counter() - t0
    return out, steady, max(first - steady, 0.0)


def report(what: str, rays: int, seconds: float, compile_s: float) -> None:
    print(f"  [{time.perf_counter() - _START:.0f}s] {what}: rays={rays} "
          f"seconds={seconds:.4f} "
          f"compile_seconds={compile_s:.2f} "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)


def pixel_diff(a, b) -> float:
    import numpy as np
    return float(np.mean(np.any(np.asarray(a) != np.asarray(b), axis=-1)))


def dt_error(t_a, t_b, hit, o) -> float:
    """Largest |t_a - t_b| / (t_b + |o|) over the rays in `hit`."""
    import numpy as np
    scale = t_b[hit] + np.linalg.norm(np.asarray(o)[hit], axis=-1)
    rel = np.abs(t_a[hit] - t_b[hit]) / scale
    return float(rel.max()) if rel.size else 0.0


def compare_traces(name: str, t_a, i_a, t_b, i_b, live, o) -> None:
    import numpy as np
    t_a, i_a, t_b, i_b, live = map(np.asarray, (t_a, i_a, t_b, i_b, live))
    agree = float(np.mean(i_a[live] == i_b[live]))
    check(f"{name} id agreement", f"{agree:.6f}", f">= {ID_AGREE}",
          agree >= ID_AGREE)
    worst = dt_error(t_a, t_b, live & (i_a == i_b) & (i_a != 0), o)
    check(f"{name} max |dt|/(t+|o|)", f"{worst:.3g}", f"<= {REL_DT}",
          worst <= REL_DT)


def phase_trace(cells) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rust_raytrace_tpu.ops.intersect_ref import nearest_hit_model
    from rust_raytrace_tpu.ops.trace import trace_kernel, trace_plain
    from rust_raytrace_tpu.render import fixed_scatter, shade_active

    print("phase 2: trace kernel at real widths", flush=True)
    rng = np.random.default_rng(0)
    for name, build in cells:
        scene, vp = scene_of(name, build)
        eng = engine_of(name, build)
        R0 = vp.width * vp.height
        R = -(-R0 // eng.ray_chunk) * eng.ray_chunk
        o, d = eng._primary_rays(vp, jax.random.PRNGKey(0), R, True)
        live = jnp.arange(R) < R0
        tb = eng.tables
        print(f"  {name}: {len(scene.tris) - 1} triangles, "
              f"{tb.num_pages} pages of {tb.page_slots}, "
              f"{tb.num_banks} banks of {tb.bank_pages}", flush=True)
        (t_k, i_k), s, c = timed(lambda: trace_kernel(tb, o.T, d.T, live))
        report(f"{name} trace_kernel primary", R0, s, c)
        (t_p, i_p), s, c = timed(
            lambda: trace_plain(tb, o.T, d.T, live, chunk=eng.ray_chunk))
        report(f"{name} trace_plain primary", R0, s, c)
        compare_traces(f"{name} kernel vs plain, all primary rays",
                       t_k, i_k, t_p, i_p, live, o)
        print("    trace_kernel memory:", trace_kernel.lower(
            tb, o.T, d.T, live).compile().memory_analysis(), flush=True)

        _, _, alive1, o1, d1 = shade_active(
            eng.tensors, o, d, t_k, i_k, jnp.ones((R,), jnp.float32), live,
            fixed_scatter(R))
        for what, oo, dd, pool in (("primary", o, d, live),
                                   ("bounce", o1, d1, alive1)):
            idx = np.flatnonzero(np.asarray(pool))
            idx = rng.choice(idx, min(SAMPLE, idx.size), replace=False)
            so = np.zeros((SAMPLE, 3), np.float32)
            sd = np.zeros((SAMPLE, 3), np.float32)
            so[:idx.size] = np.asarray(oo)[idx]
            sd[:idx.size] = np.asarray(dd)[idx]
            slive = np.arange(SAMPLE) < idx.size
            t_s, i_s = trace_kernel(tb, jnp.asarray(so.T), jnp.asarray(sd.T),
                                    jnp.asarray(slive))
            t_m, i_m = nearest_hit_model(so[slive], sd[slive], eng.pages,
                                         tie="lex")
            i_s = np.asarray(i_s)[slive]
            t_s = np.asarray(t_s)[slive]
            bad = int(np.sum(i_s != i_m))
            check(f"{name} kernel vs numpy model, {idx.size} {what} rays, "
                  "ids differing", bad, f"<= {SAMPLE_MISMATCH}",
                  bad <= SAMPLE_MISMATCH)
            worst = dt_error(t_s, t_m, (i_s == i_m) & (i_m != 0),
                             so[slive])
            check(f"{name} kernel vs numpy model, {what} max |dt|/(t+|o|)",
                  f"{worst:.3g}", f"<= {REL_DT}", worst <= REL_DT)

        excl = jnp.where(alive1, i_k, 0)
        (_, a_k), s, c = timed(lambda: trace_kernel(
            tb, o1.T, d1.T, alive1, excl, any_hit=True))
        report(f"{name} trace_kernel any-hit bounce",
               int(jnp.sum(alive1)), s, c)
        _, a_p = trace_plain(tb, o1.T, d1.T, alive1, excl, any_hit=True,
                             chunk=eng.ray_chunk)
        a_k, a_p, al = map(np.asarray, (a_k, a_p, alive1))
        agree = float(np.mean((a_k[al] != 0) == (a_p[al] != 0)))
        check(f"{name} any-hit occlusion agreement, kernel vs plain",
              f"{agree:.6f}", f">= {ID_AGREE}", agree >= ID_AGREE)


def phase_render(cells) -> None:
    from rust_raytrace_tpu.render import WavefrontRenderer
    from rust_raytrace_tpu.utils.png import quantize_u8

    print("phase 3: Engine.render", flush=True)
    for name, build, small in cells:
        scene, vp = scene_of(name, build)
        print(f"  {name}: {vp.width}x{vp.height}, spp "
              f"{vp.samples_per_pixel}, maxdepth {vp.maxdepth}, "
              f"{len(scene.tris) - 1} triangles, "
              f"light {scene.lights is not None}", flush=True)
        images = {}
        for trace in ("xla", "kernel"):
            eng = engine_of(name, build, trace)
            res, s, c = timed(lambda: eng.render(vp, fixed_rng=True))
            images[trace] = res.image
            report(f"{name} Engine(trace={trace!r}).render", res.rays_traced,
                   s, c)
            print(f"    wave rays {res.wave_rays.tolist()}", flush=True)
        frac = pixel_diff(images["kernel"], images["xla"])
        check(f"{name} kernel vs plain-XLA engine, pixels differing",
              f"{frac:.6f}", f"<= {PIXEL_DIFF}", frac <= PIXEL_DIFF)

        vps = dataclasses.replace(vp, width=small[0], height=small[1])
        ref = WavefrontRenderer(scene).render(vps, fixed_rng=True)
        img_s = eng.render(vps, fixed_rng=True).image
        frac = pixel_diff(img_s, quantize_u8(ref.image))
        check(f"{name} at {small[0]}x{small[1]} vs brute-force "
              "WavefrontRenderer, pixels differing", f"{frac:.6f}",
              f"<= {PIXEL_DIFF}", frac <= PIXEL_DIFF)


def phase_cli() -> None:
    import jax

    from rust_raytrace_tpu import cli
    from rust_raytrace_tpu.engine import Engine
    from rust_raytrace_tpu.models import circles
    from rust_raytrace_tpu.utils.png import read_png

    print("phase 3b: CLI render", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "circles_2k.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--scene", "circles", "--resolution", "2k",
                       "--out", out])
        s = time.perf_counter() - t0
        check("cli exit code", rc, "== 0", rc == 0)
        img_cli = read_png(out)
    report("cli render --scene circles --resolution 2k", 2560 * 1440, s, 0.0)
    scene, vp = circles.build(resolution="2k")
    img = Engine(scene).render(vp, key=jax.random.PRNGKey(0)).image
    frac = pixel_diff(img_cli, img)
    check("cli PNG vs Engine.render, pixels differing", f"{frac:.6f}",
          f"<= {PIXEL_DIFF}", frac <= PIXEL_DIFF)


def phase_four_cards(cells) -> None:
    print("phase 4: Engine.render_sharded over four GPUs", flush=True)
    for name, build in cells:
        scene, vp = scene_of(name, build)
        eng = engine_of(name, build)
        one, s, c = timed(lambda: eng.render(vp, fixed_rng=True))
        report(f"{name} Engine.render, one GPU", one.rays_traced, s, c)
        four, s, c = timed(lambda: eng.render_sharded(vp, n_devices=4,
                                                      fixed_rng=True))
        report(f"{name} Engine.render_sharded, four GPUs",
               four.rays_traced, s, c)
        check(f"{name} sharded vs one-GPU wave rays",
              four.wave_rays.tolist(), "equal",
              four.wave_rays.tolist() == one.wave_rays.tolist())
        frac = pixel_diff(four.image, one.image)
        check(f"{name} sharded vs one-GPU, pixels differing", f"{frac:.6f}",
              f"<= {PIXEL_DIFF}", frac <= PIXEL_DIFF)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-GPU render_sharded phase")
    args = p.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"phase 1 FAILED: JAX's first device is {dev.platform!r}, "
              "not a GPU", file=sys.stderr)
        return 1
    from rust_raytrace_tpu.utils.platform import configure_compile_cache
    configure_compile_cache()
    from rust_raytrace_tpu.models import circles, spheres

    print(f"phase 1: device {dev.platform} {dev.device_kind}, "
          f"{len(jax.devices())} devices", flush=True)
    print(card_line(), flush=True)

    circles_2k = ("circles_2k", lambda: circles.build(resolution="2k"))
    sphere_1m = ("sphere_1m_2k", lambda: spheres.build(segments=708))
    if args.four_cards:
        phase_four_cards([circles_2k, sphere_1m])
    else:
        phase_trace([circles_2k, sphere_1m])
        phase_render([
            circles_2k + ((320, 180),),
            ("sphere_100k_2k", lambda: spheres.build(segments=224),
             (320, 180)),
            sphere_1m + ((320, 180),),
            ("circles_2k_lit",
             lambda: circles.build(resolution="2k", with_light=True),
             (320, 180)),
            ("circles_512_spp4",
             lambda: circles.build(resolution=(512, 512), samples=4),
             (128, 128)),
        ])
        phase_cli()

    if _failures:
        print(f"FAILED: {len(_failures)} checks: {_failures}",
              file=sys.stderr)
        return 1
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
