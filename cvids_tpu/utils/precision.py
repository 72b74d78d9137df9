"""Numerics policy for the served path.

fp32 geometry and solver matmuls (RANSAC nullspaces, PnP normal equations,
pixel coordinates from K and A, 4-DoF Jacobian products, window-BA Hessians)
run at full fp32 precision. A GPU may otherwise run an fp32 matmul in TF32,
about three decimal digits. The dense cost volume stays bf16: bf16 operands
are unaffected by this setting.

`full_precision` wraps the server's and the agent's public entry points. The
setting is read when JAX traces, so every program traced inside the call is
compiled with it; it is thread-local, so a worker thread enters it through the
wrapped method it calls.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["full_precision"]


def full_precision(fn):
    """Run `fn` under `jax.default_matmul_precision("highest")`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapper
