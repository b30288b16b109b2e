"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Multi-device sharding tests run against XLA's host-platform device
virtualization.  Must be set before JAX initializes, hence module import
order matters (pytest loads conftest first).  Tests marked `gpu` compile
the trace kernel for a real card; they skip unless JAX_PLATFORMS names the
GPU (`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_NUM_CPU_DEVICES", "8")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

from rust_raytrace_tpu.scene import reference_asset


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "needs_teapot: requires the reference teapot OBJ asset")
    config.addinivalue_line(
        "markers", "slow: a test too long for the fast lane "
        "(pytest -m 'not slow')")


def pytest_collection_modifyitems(config, items):
    if reference_asset("raytrace", "teapot_tri.obj") is None:
        skip = pytest.mark.skip(reason="reference teapot_tri.obj not available")
        for item in items:
            if "needs_teapot" in item.keywords:
                item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:          # pragma: no cover - non-Linux
        return 0


# Compiled executables (interpret-mode Pallas + shard_map programs) each
# hold many mmap'd code regions; a full-suite run can accumulate enough to
# exhaust vm.max_map_count (65530 by default), at which point LLVM aborts
# with 'Cannot allocate memory' or segfaults inside a later compile.  Shed
# the executable caches whenever the process's map count crosses a safety
# threshold; the rare recompile afterwards is cheaper than a dead suite.
_MAPS_LIMIT = 45_000


@pytest.fixture(autouse=True)
def _shed_jax_caches_near_map_limit():
    yield
    if _n_maps() > _MAPS_LIMIT:
        jax.clear_caches()
