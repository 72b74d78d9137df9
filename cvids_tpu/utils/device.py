"""The device a run uses: a CUDA GPU, the card's name and power limit, and
JAX's persistent compile cache.

Scripts that time or check work on the card (`chip_smoke.py`, `bench.py`)
refuse to run without a GPU rather than fall back to the CPU, and print the
card's name and power limit beside every time they report: a card set below
its maximum power runs slower under load.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["card_info", "require_gpu", "compile_cache_dir",
           "configure_compile_cache"]


def card_info() -> str:
    """'<name>, <power limit>' per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    it. Runs in a child process that never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if lines else f"nvidia-smi rc={out.returncode}"


def require_gpu():
    """JAX's devices, or SystemExit(2) when the first one is not a GPU.
    There is no CPU fallback."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this run needs a CUDA GPU")
    return devs


def compile_cache_dir(repo_root: str, environ=None) -> str | None:
    """The directory to configure as JAX's persistent compile cache. None
    when `JAX_COMPILATION_CACHE_DIR` is set: JAX then reads that variable
    itself and nothing else is set in code. Otherwise the fixed
    `<repo>/.jax_cache`, so that runs from one checkout share it."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(os.path.abspath(repo_root), ".jax_cache")


def configure_compile_cache(repo_root: str) -> str:
    """Apply `compile_cache_dir`; returns the directory JAX will use."""
    import jax

    d = compile_cache_dir(repo_root)
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)
    return jax.config.jax_compilation_cache_dir
