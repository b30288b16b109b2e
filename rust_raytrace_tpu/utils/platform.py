"""Where the program runs: its compile cache and its device check."""

import os
import sys

#: compile cache used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: directory in the checkout (the path is part of the cache key)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def configure_compile_cache() -> None:
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says (JAX reads that variable itself), else in CACHE_DIR."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def trace_interpret() -> bool:
    """Whether the trace kernel must run in the Pallas interpreter.

    False on a GPU.  On the CPU only when the user asked for it with
    JAX_PLATFORMS=cpu (said on stderr); otherwise a missing GPU is an error,
    never a silent fallback.
    """
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        return False
    if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        print("JAX_PLATFORMS=cpu: rendering on the CPU, trace kernel in the "
              "Pallas interpreter (slow)", file=sys.stderr)
        return True
    raise RuntimeError(
        f"no GPU found (JAX's default device is {platform!r}). Run on a "
        "host with an NVIDIA GPU and JAX's CUDA plugin (pip install "
        "'jax[cuda12]'), or set JAX_PLATFORMS=cpu to render on the CPU with "
        "the trace kernel in interpret mode.")
