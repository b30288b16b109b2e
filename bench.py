"""Time Engine.render on one NVIDIA GPU.

    python bench.py [--runs N] [--scenes a,b,...]

For every scene that can be built from this repository (the teapot scenes
need the reference mesh and are skipped without it), and for three engine
variants — the trace kernel, the plain-XLA traversal, and the trace kernel
without compaction — prints one JSON line:

  device             platform, device_kind and count as JAX reports them
  card               name and power limit from nvidia-smi
  render_seconds     every timed Engine.render, image on the host included
  device_seconds     every timed run of the render program alone, ended by
                     block_until_ready (no host image assembly)
  median_*           medians of the two
  mrays_per_sec      traced rays / median device seconds
  compile_seconds    first call minus a steady call
  peak_bytes_in_use  device memory high-water mark of the process so far

Fails when JAX finds no GPU; there is no CPU fallback.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time


def scenes():
    from rust_raytrace_tpu.models import circles, spheres, teapot
    from rust_raytrace_tpu.scene import reference_asset

    cells = {
        "circles_2k": lambda: circles.build(resolution="2k"),
        "sphere_100k_2k": lambda: spheres.build(segments=224),
        "sphere_1m_2k": lambda: spheres.build(segments=708),
        "circles_2k_lit": lambda: circles.build(resolution="2k",
                                                with_light=True),
        "circles_512_spp4": lambda: circles.build(resolution=(512, 512),
                                                  samples=4),
    }
    if reference_asset("raytrace", "teapot_tri.obj") is not None:
        cells["teapot_2k"] = lambda: teapot.build(resolution="2k")
    return cells


VARIANTS = {
    "kernel": {},
    "xla": {"trace": "xla"},
    "kernel_no_compact": {"compact": False},
}


def bench_scene(name, build, runs: int, card: str):
    import jax
    import jax.numpy as jnp

    from rust_raytrace_tpu.engine import Engine, _render_device
    from rust_raytrace_tpu.render import light_args

    dev = jax.devices()[0]
    scene, vp = build()
    for variant, kw in VARIANTS.items():
        eng = Engine(scene, **kw)
        key = jax.random.PRNGKey(0)
        spp = vp.samples_per_pixel
        R0 = vp.width * vp.height * spp
        R = -(-R0 // eng._quantum(spp)) * eng._quantum(spp)
        o, d = eng._primary_rays(vp, key, R, False)
        alive = jnp.arange(R) < R0
        statics = eng._statics(vp, fixed_rng=False, debug=False, quant=True,
                               spp=spp)

        def device_render(k):
            return _render_device(eng.tensors, eng.tables, o, d, alive, k,
                                  light_args(scene), **statics)

        t0 = time.perf_counter()
        jax.block_until_ready(device_render(key))
        first = time.perf_counter() - t0
        dev_s, rays = [], 0
        for i in range(runs):
            t0 = time.perf_counter()
            out = jax.block_until_ready(device_render(
                jax.random.PRNGKey(100 + i)))
            dev_s.append(time.perf_counter() - t0)
            rays = int(out[1].sum())
        render_s = []
        for i in range(runs):
            t0 = time.perf_counter()
            eng.render(vp, key=jax.random.PRNGKey(200 + i))
            render_s.append(time.perf_counter() - t0)
        med = statistics.median(dev_s)
        print(json.dumps({
            "scene": name, "variant": variant,
            "resolution": f"{vp.width}x{vp.height}", "spp": spp,
            "maxdepth": vp.maxdepth, "triangles": len(scene.tris) - 1,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card, "rays": rays,
            "device_seconds": dev_s, "median_device_seconds": med,
            "render_seconds": render_s,
            "median_render_seconds": statistics.median(render_s),
            "mrays_per_sec": rays / med / 1e6,
            "compile_seconds": max(first - min(dev_s), 0.0),
            "peak_bytes_in_use": dev.memory_stats()["peak_bytes_in_use"],
        }), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--scenes", help="comma-separated subset of the scenes")
    args = p.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX's first device is {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    from rust_raytrace_tpu.utils.platform import configure_compile_cache
    configure_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cells = scenes()
    wanted = args.scenes.split(",") if args.scenes else list(cells)
    for name in wanted:
        bench_scene(name, cells[name], args.runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
