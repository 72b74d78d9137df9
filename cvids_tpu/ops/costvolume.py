"""Plane-sweep absolute-difference cost volume.

Redesign of the reference's `ADCalcCostKernel`
(`/root/reference/server_pose_graph/src/dense_mapping/calc_cost.cu:20-233`):
for every pixel and every inverse-depth hypothesis, warp into the measurement
frame via the per-hypothesis homography  x₂ ~ A x₁ + b·ρ  (A = K₂R₂₁K₁⁻¹,
b = K₂t₂₁), sample bilinearly, and accumulate an absolute-difference cost
averaged over a 3×3 patch with a running mean across measurement frames and
a -1 sentinel for out-of-view pixels.

The sweep is the reference's own shape: one bilinear gather per (pixel,
hypothesis) from the measurement image, which stays cache-resident. The
volume is (H, W, D) with the hypotheses innermost. One difference from the
CUDA kernel: the 9-tap patch AD (center + 4 + 4 diagonal taps of the *warped*
image, `calc_cost.cu:96-223`) is a 3×3 box filter over the per-pixel AD
volume, identical for locally-translational warps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .image import bilinear_sample

__all__ = ["plane_sweep_cost", "accumulate_cost", "warp_coords"]


def warp_coords(a_mat: jax.Array, b_vec: jax.Array, inv_depths: jax.Array,
                height: int, width: int) -> jax.Array:
    """Warped pixel coordinates (H, W, D, 2) for each inverse-depth plane.

    a_mat: (3,3) = K2 @ R_21 @ K1^-1;  b_vec: (3,) = K2 @ t_21;
    inv_depths: (D,).  x2_h = a_mat @ [u, v, 1] + b_vec * rho.
    The 3×3 product is written out elementwise, so the coordinates are
    exact fp32 whatever the backend's matmul precision. Points at or behind
    the measurement camera (z <= 1e-6) get NaN coordinates, which sample as
    out of view.
    """
    f32 = jnp.float32
    a = a_mat.astype(f32)
    b = b_vec.astype(f32)
    rho = inv_depths.astype(f32)
    u = jnp.arange(width, dtype=f32)[None, :, None]
    v = jnp.arange(height, dtype=f32)[:, None, None]
    p = [a[i, 0] * u + a[i, 1] * v + a[i, 2] + b[i] * rho for i in range(3)]
    front = p[2] > 1e-6
    z = jnp.where(front, p[2], 1.0)
    return jnp.where(front[..., None],
                     jnp.stack([p[0] / z, p[1] / z], axis=-1), jnp.nan)


def _box3(x: jax.Array) -> jax.Array:
    """3x3 box filter over the two leading dims (edge-replicated)."""
    h, w = x.shape[0], x.shape[1]
    pads = [(1, 1), (1, 1)] + [(0, 0)] * (x.ndim - 2)
    xp = jnp.pad(x, pads, mode="edge")
    acc = jnp.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[dy:dy + h, dx:dx + w]
    return acc / 9.0


def plane_sweep_cost(ref: jax.Array, meas: jax.Array,
                     a_mat: jax.Array, b_vec: jax.Array,
                     inv_depths: jax.Array,
                     out_dtype=None) -> tuple[jax.Array, jax.Array]:
    """One measurement frame's cost slice.

    ref, meas: (H, W) float intensity images. a_mat = K₂R₂₁K₁⁻¹ (3,3),
    b_vec = K₂t₂₁ (3,). Returns (cost (H, W, D), valid (H, W, D)) where
    invalid = the warped center sample falls outside the measurement image.
    The patch cost averages 9 taps with out-of-view taps contributing 0 (the
    CUDA kernel's clamped taps and -1 sentinel, `calc_cost.cu:96-233`).
    Sampling and AD run in fp32; the cost is stored in `out_dtype`.
    """
    h, w = ref.shape
    f32 = jnp.float32
    coords = warp_coords(a_mat, b_vec, inv_depths, h, w)        # (H, W, D, 2)
    warped = bilinear_sample(meas.astype(f32), coords, fill=jnp.nan)
    ad = jnp.abs(warped - ref.astype(f32)[..., None])
    valid = jnp.isfinite(ad)
    cost = _box3(jnp.where(valid, ad, 0.0))
    return cost.astype(out_dtype or f32), valid


def accumulate_cost(mean_cost: jax.Array, count: jax.Array,
                    new_cost: jax.Array, new_valid: jax.Array):
    """Running mean across measurement frames (the CUDA kernel's in-place
    accumulation, `calc_cost.cu:224-230`). Invalid samples don't count.

    mean_cost/count: (H, W, D). Returns updated (mean_cost, count).
    """
    c = count + new_valid.astype(mean_cost.dtype)
    upd = jnp.where(new_valid,
                    mean_cost + (new_cost - mean_cost) / jnp.maximum(c, 1.0),
                    mean_cost)
    return upd, c
