"""Semi-global matching: 4 directional scans + WTA with subpixel refinement.

Redesign of the reference's `sgm2` CUDA kernels and `filterCostKernel`
(`/root/reference/server_pose_graph/src/dense_mapping/calc_cost.cu:366-546,
235-283`). Each scan orientation runs forward and backward together: on a
GPU as one Pallas kernel that walks the scan axis with the (X, D) carry on
chip (`ops.sgm_triton`), elsewhere as a `lax.scan` whose carry is the whole
(X, D) slice (`_scan_bidir`, also the kernel's reference).

Penalties follow the reference semantics: P1 for ±1 disparity moves, P2
(image-gradient modulated) for larger jumps, and the classic min-normalization
`- min_d L(p-1, d)` keeping the carry bounded. Defaults pi1=16, pi2=64,
tau_so=8, q1=q2=1 mirror `dense_mapping_parameters.cpp:1-13`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sgm_triton import sgm_scan_bidir

__all__ = ["sgm_aggregate", "sgm_aggregate_parts", "sgm_penalties",
           "scan_pair", "scan_pair_plain", "wta_depth", "sgm_depth"]


def _shift_d(l: jax.Array, s: int) -> jax.Array:
    """Shift along the last (depth) axis with +inf padding."""
    big = jnp.asarray(jnp.inf, l.dtype)
    if s == 1:
        return jnp.concatenate([jnp.full_like(l[..., :1], big), l[..., :-1]], -1)
    return jnp.concatenate([l[..., 1:], jnp.full_like(l[..., :1], big)], -1)


def _sgm_update(l_prev: jax.Array, c: jax.Array, p2: jax.Array,
                p1: jax.Array) -> jax.Array:
    """One SGM recurrence step: L(p) = C(p) + min(...) − min_d L(p−1)."""
    min_prev = jnp.min(l_prev, axis=-1, keepdims=True)
    cand = jnp.minimum(
        l_prev,
        jnp.minimum(jnp.minimum(_shift_d(l_prev, 1), _shift_d(l_prev, -1)) + p1,
                    min_prev + p2[..., None]))
    return c + cand - min_prev


def _scan_bidir(cost: jax.Array, p1: jax.Array, p2_eff: jax.Array,
                unroll: int = 8) -> jax.Array:
    """Forward + backward directional passes along axis 0 of (S, X, D) cost,
    returned pre-summed: agg_fwd + agg_bwd.

    The recurrence is sequential and each step's work (a handful of
    element-wise mins on an (X, D) slice) is small, so the scan is
    step-overhead bound: both directions ride one scan (independent
    carries), and `unroll` recurrence steps run inside each scan body.
    """
    s = cost.shape[0]
    n = s - 1
    pad = (-n) % unroll
    cost_b = cost[::-1]
    p2_b = p2_eff[::-1]

    def prep(c, p2):
        cs = jnp.concatenate(
            [c[1:], jnp.zeros((pad,) + c.shape[1:], c.dtype)])
        ps = jnp.concatenate(
            [p2[1:], jnp.zeros((pad,) + p2.shape[1:], p2.dtype)])
        blk = (n + pad) // unroll
        return (cs.reshape((blk, unroll) + c.shape[1:]),
                ps.reshape((blk, unroll) + p2.shape[1:]))

    cf, pf = prep(cost, p2_eff)
    cb, pb = prep(cost_b, p2_b)

    def step(carry, inp):
        lf, lb = carry
        cfi, pfi, cbi, pbi = inp
        outs_f, outs_b = [], []
        for k in range(unroll):
            lf = _sgm_update(lf, cfi[k], pfi[k], p1)
            lb = _sgm_update(lb, cbi[k], pbi[k], p1)
            outs_f.append(lf)
            outs_b.append(lb)
        return (lf, lb), (jnp.stack(outs_f), jnp.stack(outs_b))

    (_, _), (of, ob) = jax.lax.scan(step, (cost[0], cost_b[0]),
                                    (cf, pf, cb, pb))
    of = of.reshape((n + pad,) + cost.shape[1:])[:n]
    ob = ob.reshape((n + pad,) + cost.shape[1:])[:n]
    agg_f = jnp.concatenate([cost[0][None], of], axis=0)
    agg_b = jnp.concatenate([cost_b[0][None], ob], axis=0)[::-1]
    return agg_f + agg_b


def sgm_aggregate(cost: jax.Array, grad: jax.Array,
                  pi1: float = 16.0, pi2: float = 64.0,
                  tau_so: float = 8.0, q1: float = 1.0, q2: float = 1.0,
                  penalty_scale: jax.Array | None = None) -> jax.Array:
    """4-direction SGM aggregation of (H, W, D) cost.

    Penalty modulation mirrors `sgm2`'s alpha/tau_so scheme in spirit: where
    the image gradient along the scan direction exceeds tau_so, the jump
    penalty drops (gradients license discontinuities):
        P2 = pi2 / q2  if |∇I| > tau_so else pi2
        P1 = pi1 / q1  if |∇I| > tau_so else pi1   (q1=1 -> unchanged)
    `penalty_scale` (H, W) optionally multiplies both (the reference's
    per-pixel `0.8 + 1.5 mean³/(1+|∇|³)` map from `InitReference`,
    `sgm_stereo_mapper.cpp:55-123`).
    """
    parts = sgm_aggregate_parts(cost, grad, pi1=pi1, pi2=pi2, tau_so=tau_so,
                                q1=q1, q2=q2, penalty_scale=penalty_scale)
    return parts[0] + parts[1]


def sgm_aggregate_parts(cost: jax.Array, grad: jax.Array,
                        pi1: float = 16.0, pi2: float = 64.0,
                        tau_so: float = 8.0, q1: float = 1.0, q2: float = 1.0,
                        penalty_scale: jax.Array | None = None
                        ) -> tuple[jax.Array, jax.Array]:
    """The two orientation parts of `sgm_aggregate`, not yet summed:
    (L→R + R→L, T→B + B→T), each (H, W, D), so the consumer can sum them
    in fp32 inside its own fusion."""
    p2_map, p1 = sgm_penalties(grad, cost.dtype, pi1, pi2, tau_so, q1, q2,
                               penalty_scale)
    return (scan_pair(cost, p2_map, p1, axis=1),
            scan_pair(cost, p2_map, p1, axis=0))


def sgm_penalties(grad: jax.Array, dtype, pi1: float = 16.0,
                  pi2: float = 64.0, tau_so: float = 8.0, q1: float = 1.0,
                  q2: float = 1.0, penalty_scale: jax.Array | None = None):
    """(P2 map (H, W), scalar P1) in `dtype` for `scan_pair`."""
    big_jump = grad > tau_so
    p2_map = jnp.where(big_jump, pi2 / q2, pi2).astype(dtype)
    p1_map = jnp.where(big_jump, pi1 / q1, pi1).astype(dtype)
    if penalty_scale is not None:
        p2_map = p2_map * penalty_scale.astype(dtype)
        p1_map = p1_map * penalty_scale.astype(dtype)
    return p2_map, jnp.mean(p1_map)  # P1 is effectively constant upstream


def scan_pair_plain(cost: jax.Array, p2_map: jax.Array, p1: jax.Array,
                    axis: int) -> jax.Array:
    """Forward + backward aggregation of (H, W, D) `cost` along `axis`,
    summed, as a `lax.scan` (the SGM kernel's reference)."""
    if axis == 0:
        return _scan_bidir(cost, p1, p2_map)
    return jnp.swapaxes(
        _scan_bidir(jnp.swapaxes(cost, 0, 1), p1, p2_map.T), 0, 1)


def scan_pair(cost: jax.Array, p2_map: jax.Array, p1: jax.Array,
              axis: int) -> jax.Array:
    """`scan_pair_plain`'s contract. Lowered for a CUDA GPU this is the
    Pallas kernel (`ops.sgm_triton`); for any other platform the
    `lax.scan` form."""
    return jax.lax.platform_dependent(
        cost, p2_map, p1,
        default=lambda c, p2, q: scan_pair_plain(c, p2, q, axis),
        cuda=lambda c, p2, q: sgm_scan_bidir(c, p2, q, axis=axis))


def wta_depth(cost: jax.Array, valid_count: jax.Array | None = None,
              min_count: float = 1.0, peak_ratio: float = 0.98):
    """Winner-take-all over the depth axis + parabola subpixel refinement +
    peak-sharpness rejection (`filterCostKernel`, `calc_cost.cu:235-283`).

    Returns (idx_float (H, W), conf (H, W) bool).
    """
    d = cost.shape[-1]
    idx = jnp.argmin(cost, axis=-1)
    c0 = jnp.min(cost, axis=-1)
    # parabola through (idx-1, idx, idx+1); the neighbours are fetched by a
    # masked reduction over the depth axis, which fuses with the argmin pass
    lane = jnp.arange(d)
    im = jnp.clip(idx - 1, 0, d - 1)
    ip = jnp.clip(idx + 1, 0, d - 1)
    cm = jnp.sum(jnp.where(lane == im[..., None], cost, 0.0), axis=-1)
    cp = jnp.sum(jnp.where(lane == ip[..., None], cost, 0.0), axis=-1)
    denom = cm + cp - 2.0 * c0
    delta = jnp.where(denom > 1e-6, 0.5 * (cm - cp) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    idx_f = idx.astype(cost.dtype) + delta
    # peak sharpness: second-best (excluding +-1 neighborhood) must be
    # sufficiently worse than the best
    masked = jnp.where(
        jnp.abs(jnp.arange(d)[None, None, :] - idx[..., None]) <= 1,
        jnp.inf, cost)
    c2 = jnp.min(masked, axis=-1)
    conf = c0 < peak_ratio * c2
    conf = conf & (idx > 0) & (idx < d - 1)
    if valid_count is not None:
        conf = conf & (valid_count >= min_count)
    return idx_f, conf


def sgm_depth(cost: jax.Array, grad: jax.Array, inv_depths: jax.Array,
              valid_count: jax.Array | None = None, min_count: float = 1.0,
              **kw):
    """Aggregate + WTA + map to inverse depth. Returns (inv_depth, conf).

    Aggregation is stored in the cost dtype (bf16-safe: min algebra); the
    two parts are summed and the WTA's subpixel parabola runs in fp32."""
    part_h, part_v = sgm_aggregate_parts(cost, grad, **kw)
    agg = part_h.astype(jnp.float32) + part_v.astype(jnp.float32)
    idx_f, conf = wta_depth(agg, valid_count, min_count)
    step = inv_depths[1] - inv_depths[0]
    inv_depth = inv_depths[0] + idx_f * step
    return inv_depth, conf
