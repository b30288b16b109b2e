"""Auxiliary subsystems: progress stats, ray debug differ, CLI."""

import io

import numpy as np
import pytest

from rust_raytrace_tpu.utils.progress import ProgressStat, create_ctx
from rust_raytrace_tpu.utils.raydebug import DebugCtx


def test_progress_stats_report():
    ctx = create_ctx(4, 4, enable_io=False)
    ctx.update(8, {"Rays": 100, "Render": 0.5},
               kinds={"Rays": "count", "Render": "time"})
    ctx.update(8, {"Rays": 50}, kinds={"Rays": "count"})
    ctx.finish()
    assert ctx.total_rays == 150
    assert ctx.finished_pixels == 16
    lines = []
    ctx.print_stats(out=lines.append)
    assert "million rays" in lines[0]
    assert any(l.startswith("Render:") for l in lines)
    assert any(l.startswith("Rays: 150") for l in lines)


def test_debug_ctx_roundtrip_and_compare():
    a = DebugCtx()
    b = DebugCtx()
    o = np.asarray([1.0, 2.0, 3.0])
    d = np.asarray([0.0, 0.0, 1.0])
    for ctx in (a, b):
        ctx.register_ray(o, (0, 0))
        ctx.add_ray(o, d)
        ctx.update_ray_triangles(o, [5, 3, 5])
    a.update_ray_hit(o, 3, 1.5)
    b.update_ray_hit(o, 3, 1.5)

    out = io.StringIO()
    a.write_debug_header(out)
    a.write_all_debug_context(out)
    text = out.getvalue()
    assert text.startswith("Pixel_x;Pixel_y;ray_p;ray_v;tri_hit;hit_t")
    assert "3,5" in text  # deduped sorted candidate list

    diff = io.StringIO()
    assert a.compare_to(b, diff) == 0

    # hit mismatch classified: b's hit is in a's candidate list
    b.update_ray_hit(o, 5, 1.5)
    diff = io.StringIO()
    assert a.compare_to(b, diff) == 1
    assert "Bad hit detection" in diff.getvalue()

    # a's hit NOT in b's candidates -> "their tri list does not contain"
    # (classification per debug.rs:194-204)
    c = DebugCtx()
    c.register_ray(o, (0, 0))
    c.add_ray(o, d)
    c.update_ray_triangles(o, [99])
    c.update_ray_hit(o, 99, 1.5)
    diff = io.StringIO()
    a.compare_to(c, diff)
    assert "does not contain our hit" in diff.getvalue()


def test_cli_render_oracle(tmp_path):
    from rust_raytrace_tpu.cli import main

    out = str(tmp_path / "t.png")
    rc = main(["render", "--scene", "circles", "--resolution", "16x16",
               "--backend", "oracle", "--maxdepth", "2", "--out", out,
               "--stats"])
    assert rc == 0
    from rust_raytrace_tpu.utils.png import read_png

    img = read_png(out)
    assert img.shape == (16, 16, 3)


def test_cli_debug_csv(tmp_path):
    from rust_raytrace_tpu.cli import main

    csv = str(tmp_path / "d.csv")
    rc = main(["render", "--scene", "circles", "--resolution", "16x16",
               "--backend", "xla", "--maxdepth", "1", "--out",
               str(tmp_path / "t.png"), "--debug-csv", csv])
    assert rc == 0
    text = open(csv).read()
    assert text.startswith("Pixel_x;Pixel_y")
    assert len(text.splitlines()) == 1 + 16 * 16


def test_depth_indented_trace_logging(caplog):
    """RUST_LOG analog: per-ray + per-box depth-indented tracing
    (raytrace.rs:912-918, 954-958, 1027, 1259)."""
    import logging

    import numpy as np

    from rust_raytrace_tpu import math3d as m3
    from rust_raytrace_tpu import oracle
    from rust_raytrace_tpu.geometry import make_sphere
    from rust_raytrace_tpu.materials import matte
    from rust_raytrace_tpu.octree import (build_bounding_box,
                                          get_object_intersection_for_ray)
    from rust_raytrace_tpu.scene import assemble

    scene = assemble([make_sphere((0.0, 0.0, 6.0), 2.0, (6, 8),
                                  matte(m3.make_color((250, 0, 0)), 0.2),
                                  0.05)])
    tree = build_bounding_box(scene.tris, (0.0, 0.0, 6.0), 6.0, 3, 6)
    with caplog.at_level(logging.DEBUG, logger="rust_raytrace_tpu.trace"):
        oracle.project_ray(scene.tris, np.zeros(3, np.float32),
                           np.asarray([0, 0, 1], np.float32), 1,
                           oracle.FixedRng())
        get_object_intersection_for_ray(
            tree, scene.tris, np.zeros(3, np.float32),
            np.asarray([0, 0, 1], np.float32))
    text = caplog.text
    assert "Ray: orig=" in text
    assert "Bounding box: " in text
    # depth indentation present: a depth>=1 node line starts with a space
    assert any(r.msg.startswith("%sBounding box") and r.args[0] == " "
               for r in caplog.records) or " Bounding box:" in text


@pytest.mark.parametrize("pattern", ["random", "all", "none", "tail"])
def test_compact_expand_roundtrip(pattern):
    """XLA compaction: live rays move to a prefix in their previous order,
    dead ones follow in theirs, and expansion returns every row exactly."""
    import jax.numpy as jnp

    from rust_raytrace_tpu.ops.compact import compact, compact_order, expand

    R = 1000
    rng = np.random.default_rng(4)
    alive = {"random": rng.random(R) < 0.3, "all": np.ones(R, bool),
             "none": np.zeros(R, bool),
             "tail": np.arange(R) >= R - 7}[pattern]
    x = rng.normal(size=(R, 3)).astype(np.float32)
    order = np.asarray(compact_order(jnp.asarray(alive)))
    assert sorted(order.tolist()) == list(range(R))       # a permutation
    n = int(alive.sum())
    np.testing.assert_array_equal(order[:n], np.flatnonzero(alive))
    np.testing.assert_array_equal(order[n:], np.flatnonzero(~alive))
    y = compact(jnp.asarray(x), jnp.asarray(order))
    np.testing.assert_array_equal(np.asarray(y)[:n], x[alive])
    np.testing.assert_array_equal(
        np.asarray(expand(y, jnp.asarray(order))), x)


def test_compaction_composes():
    """Two compactions in a row, composed through the slot->ray index the
    engine carries, still expand back to the original positions."""
    import jax.numpy as jnp

    from rust_raytrace_tpu.ops.compact import compact, compact_order, expand

    R = 512
    rng = np.random.default_rng(5)
    x = rng.normal(size=(R,)).astype(np.float32)
    src = jnp.arange(R, dtype=jnp.int32)
    y = jnp.asarray(x)
    for p in (0.6, 0.4):
        order = compact_order(jnp.asarray(rng.random(R) < p))
        y, src = compact(y, order), compact(src, order)
    np.testing.assert_array_equal(np.asarray(expand(y, src)), x)


def test_engine_rejects_bad_options():
    """Unknown traversal names and ray chunks that split a kernel block are
    refused at construction, not deep inside a compiled program."""
    from rust_raytrace_tpu.engine import Engine
    from rust_raytrace_tpu.models import circles
    from rust_raytrace_tpu.ops.trace import BLOCK

    s, _ = circles.build(resolution=(16, 16))
    with pytest.raises(ValueError, match="trace"):
        Engine(s, trace="pallas")
    with pytest.raises(ValueError, match="multiple"):
        Engine(s, ray_chunk=BLOCK + BLOCK // 2)
    assert Engine(s, trace="xla").plain


def test_cli_refuses_to_run_without_gpu(monkeypatch, tmp_path):
    """No silent CPU fallback: without a GPU the CLI stops with an error
    naming the fix, unless JAX_PLATFORMS=cpu asked for the CPU."""
    from rust_raytrace_tpu.cli import main

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit, match="JAX_PLATFORMS=cpu"):
        main(["render", "--scene", "circles", "--resolution", "16x16",
              "--out", str(tmp_path / "t.png")])
    assert not (tmp_path / "t.png").exists()
    # the numpy oracle needs no device and still runs
    assert main(["render", "--scene", "circles", "--resolution", "8x8",
                 "--backend", "oracle", "--maxdepth", "1",
                 "--out", str(tmp_path / "o.png")]) == 0


def test_cli_render_engine_on_requested_cpu(tmp_path, capsys):
    """JAX_PLATFORMS=cpu (set for the whole suite) runs the engine with the
    trace kernel in interpret mode and says so on stderr."""
    from rust_raytrace_tpu.cli import main
    from rust_raytrace_tpu.utils.png import read_png

    out = str(tmp_path / "e.png")
    assert main(["render", "--scene", "circles", "--resolution", "32x16",
                 "--maxdepth", "2", "--ray-chunk", "128", "--out", out]) == 0
    assert "interpret" in capsys.readouterr().err
    assert read_png(out).shape == (16, 32, 3)
