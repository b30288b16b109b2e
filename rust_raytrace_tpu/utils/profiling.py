"""Profiling helpers (reference component #24).

The reference keeps traversal frames visible to `perf` with #[inline(never)]
(raytrace.rs:860,909,1012), dedups recursive flamegraph frames with
`stackcollapse-recursive.py`, and used NVVP/Nsight for the CUDA side
(.gitignore artifacts).  The equivalents here:

  - `trace(logdir)` — wrap a render in a jax.profiler trace; view the xplane
    in TensorBoard/XProf (kernel timelines replace flamegraphs);
  - `annotate(name)` — a TraceAnnotation so engine phases (cull / trace /
    shade) show up as named spans;
  - `phase_timers()` — host-side named phase timing, each phase ended by
    jax.block_until_ready on its result, the analog of the reference's
    4-phase nanosecond CUDA timers (cuda_rt.cu:432-440).
"""

import contextlib
import time
from typing import Dict



@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace around a block: `with trace('/tmp/xp'): render()`."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span for device traces (shows in XProf timelines)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def sync(x) -> None:
    """Wait until a device value (or a tuple/list of them) is computed."""
    import jax

    jax.block_until_ready(x)


class phase_timers:
    """Named wall-clock phases with device sync (ProgressStat Time analog).

    with phase_timers() as pt:
        with pt.phase("trace"):   out = kernel(...)
        with pt.phase("shade"):   img = shade(out)
    pt.report()  # dict of seconds
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                sync(sync_value)
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)

    def report(self) -> Dict[str, float]:
        return dict(self.times)
