"""SGM directional aggregation as one GPU kernel (Pallas, Triton route).

The recurrence L(p) = C(p) + min(L, L(d±1) + P1, min L + P2) − min L is
sequential along the scan axis. As a `lax.scan` (`sgm._scan_bidir`) XLA runs
it as a loop with several kernel launches per step. Here each single-warp
program owns one scanline and walks the whole scan axis inside the kernel
with both direction carries (1, D) held in registers — the shape of the reference's
`sgm2` kernels (`calc_cost.cu:366-546`). The ±1 depth shift is read back from
a small double-buffered scratch row (Triton has no in-register shift), one
block barrier per step.

The volume stays (H, W, D); `axis` picks the scan axis, so neither
orientation needs a transpose. The forward and backward results are written
to two volumes and summed by the caller's fusion.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["sgm_scan_bidir"]

# scanlines per program and warps per program: one and one were the fastest
# of the block shapes measured at 480x640x128 (PERF.md)
_SCANLINES = 1
_WARPS = 1


def _sgm_kernel(p1_ref, cost_ref, p2_ref, out_f_ref, out_b_ref, scr_ref, *,
                axis: int, bx: int, barrier: bool):
    pid = pl.program_id(0)
    x0 = pid * bx
    s_len = cost_ref.shape[axis]
    d = cost_ref.shape[-1]
    rows = pl.ds(x0, bx)
    p1 = p1_ref[0]
    big = jnp.full((bx, d), jnp.inf, jnp.float32)

    def vol(s):
        return (s, rows, slice(None)) if axis == 0 else (rows, s, slice(None))

    def pen(s):
        return (s, rows) if axis == 0 else (rows, s)

    def sync():
        if barrier:
            plgpu.debug_barrier()

    # +inf guard columns 0 and d+1 of every scratch row; the carries are
    # published into columns [1, d+1) each step
    for k in range(2):
        for par in range(2):
            scr_ref[pid, k, par, :, pl.ds(0, d)] = big
            scr_ref[pid, k, par, :, pl.ds(2, d)] = big
    sync()

    lf = cost_ref[vol(0)].astype(jnp.float32)
    lb = cost_ref[vol(s_len - 1)].astype(jnp.float32)
    out_f_ref[vol(0)] = lf.astype(out_f_ref.dtype)
    out_b_ref[vol(s_len - 1)] = lb.astype(out_b_ref.dtype)

    def update(l_prev, lo, hi, c, p2):
        min_prev = jnp.min(l_prev, axis=-1, keepdims=True)
        cand = jnp.minimum(l_prev, jnp.minimum(jnp.minimum(lo, hi) + p1,
                                               min_prev + p2[:, None]))
        return c + cand - min_prev

    def step(i, carry):
        lf, lb = carry
        sb = s_len - 1 - i
        par = jax.lax.rem(i, 2)
        scr_ref[pid, 0, par, :, pl.ds(1, d)] = lf
        scr_ref[pid, 1, par, :, pl.ds(1, d)] = lb
        sync()
        lf = update(lf, scr_ref[pid, 0, par, :, pl.ds(0, d)],
                    scr_ref[pid, 0, par, :, pl.ds(2, d)],
                    cost_ref[vol(i)].astype(jnp.float32),
                    p2_ref[pen(i)].astype(jnp.float32))
        lb = update(lb, scr_ref[pid, 1, par, :, pl.ds(0, d)],
                    scr_ref[pid, 1, par, :, pl.ds(2, d)],
                    cost_ref[vol(sb)].astype(jnp.float32),
                    p2_ref[pen(sb)].astype(jnp.float32))
        out_f_ref[vol(i)] = lf.astype(out_f_ref.dtype)
        out_b_ref[vol(sb)] = lb.astype(out_b_ref.dtype)
        return lf, lb

    jax.lax.fori_loop(1, s_len, step, (lf, lb))


@partial(jax.jit, static_argnames=("axis", "interpret"))
def sgm_scan_bidir(cost: jax.Array, p2_map: jax.Array, p1: jax.Array,
                   axis: int, interpret: bool = False) -> jax.Array:
    """Forward + backward SGM aggregation of an (H, W, D) volume along `axis`
    (0 = top/bottom, 1 = left/right), summed: the `sgm._scan_bidir` contract
    without the transpose. p2_map: (H, W) jump penalty; p1: scalar.

    The depth axis is padded with +inf to a power of two (a padded depth can
    never win a min). `interpret` runs the Pallas interpreter (tests)."""
    h, w, d = cost.shape
    dp = pl.next_power_of_2(d)
    if dp != d:
        cost = jnp.pad(cost, ((0, 0), (0, 0), (0, dp - d)),
                       constant_values=jnp.inf)
    grid = (w if axis == 0 else h) // _SCANLINES
    vol = jax.ShapeDtypeStruct((h, w, dp), cost.dtype)
    scratch = jax.ShapeDtypeStruct((grid, 2, 2, _SCANLINES, dp + 2),
                                   jnp.float32)
    out_f, out_b, _ = pl.pallas_call(
        partial(_sgm_kernel, axis=axis, bx=_SCANLINES,
                barrier=not interpret),
        out_shape=(vol, vol, scratch),
        grid=(grid,),
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS, num_stages=1),
        interpret=interpret,
        name=f"sgm_scan_axis{axis}",
    )(jnp.asarray(p1, jnp.float32).reshape(1), cost, p2_map)
    return (out_f + out_b)[..., :d]
