"""Banded-matmul plane sweep: an independent formulation of
`ops.costvolume.plane_sweep_cost`, kept here as a test oracle.

The per-hypothesis sample point is x₂ ~ A x₁ + b ρ. With
meas_aligned(x) := meas(A x) (one projective warp), sampling meas at
A x₁ + b ρ equals sampling meas_aligned at x₁ + c ρ with c = A⁻¹ b:
    u₂ = (u + c₀ρ) s,  v₂ = (v + c₁ρ) s,  s = 1/(1 + c₂ρ)
a per-depth uniform scale+translation, separable in u and v. So the sweep is
two batched matmuls against banded hat-function interpolation matrices, and
the pre-warp is a two-pass (Catmull-Smith) resampling, also as matmuls.
Validity is analytic: the sample's hat support lies inside the aligned image
and the aligned image is itself valid there (affine half-plane tests).
"""

import jax.numpy as jnp

f32 = jnp.float32


def _hat(pos, size):
    """(..., N, size) bilinear hat weights max(0, 1 - |pos - j|)."""
    return jnp.maximum(0.0, 1.0 - jnp.abs(pos[..., None] - jnp.arange(size, dtype=f32)))


def projective_warp_matmul(img, m, eps=1e-3):
    """out(u, v) = img(m @ [u, v, 1]) by two resampling matmuls. Returns
    (warped * coverage, coverage)."""
    h, w = img.shape
    m = m.astype(f32)
    u = jnp.arange(w, dtype=f32)
    v = jnp.arange(h, dtype=f32)
    r = jnp.arange(h, dtype=f32)
    den_v = m[1, 1] - r * m[2, 1]
    deg = jnp.abs(den_v) < eps
    v_ur = ((r[:, None] * (m[2, 0] * u[None, :] + m[2, 2])
             - m[1, 0] * u[None, :] - m[1, 2])
            / jnp.where(deg, 1.0, den_v)[:, None])
    zd = m[2, 0] * u[None, :] + m[2, 1] * v_ur + m[2, 2]
    zd = jnp.where(jnp.abs(zd) > 1e-6, zd, 1e-6)
    g = (m[0, 0] * u[None, :] + m[0, 1] * v_ur + m[0, 2]) / zd
    g = jnp.where(deg[:, None], -1e9, g)
    zz = m[2, 0] * u[None, :] + m[2, 1] * v[:, None] + m[2, 2]
    zz = jnp.where(jnp.abs(zz) > 1e-6, zz, 1e-6)
    y_in = (m[1, 0] * u[None, :] + m[1, 1] * v[:, None] + m[1, 2]) / zz
    stack = jnp.stack([img.astype(f32), jnp.ones_like(img, f32)])
    tmp = jnp.einsum("crx,rux->cru", stack, _hat(g, w), precision="highest")
    out = jnp.einsum("cru,uvr->cvu", tmp, _hat(y_in.T, h), precision="highest")
    return out[0], out[1]


def plane_sweep_cost_banded(ref, meas, a_mat, b_vec, inv_depths):
    """(cost (H, W, D), valid (H, W, D)) in fp32, same contract as
    `plane_sweep_cost`."""
    h, w = ref.shape
    a = a_mat.astype(f32)
    meas_cov, cov = projective_warp_matmul(meas.astype(f32), a)
    meas_al = meas_cov / jnp.maximum(cov, 1e-3)

    c = jnp.linalg.solve(a, b_vec.astype(f32))
    rho = inv_depths.astype(f32)
    den = 1.0 + c[2] * rho
    s = jnp.where(jnp.abs(den) > 1e-3, 1.0 / den, 0.0)
    depth_ok = den > 1e-3
    u = jnp.arange(w, dtype=f32)
    v = jnp.arange(h, dtype=f32)
    pos_x = jnp.where(depth_ok[:, None], (u[None] + (c[0] * rho)[:, None]) * s[:, None], -1e9)
    pos_y = jnp.where(depth_ok[:, None], (v[None] + (c[1] * rho)[:, None]) * s[:, None], -1e9)

    rowp = jnp.einsum("hw,dpw->dhp", meas_al, _hat(pos_x, w), precision="highest")
    warped = jnp.einsum("dhp,dqh->dqp", rowp, _hat(pos_y, h), precision="highest")

    px = pos_x[:, None, :]
    py = pos_y[:, :, None]
    m = [a[i, 0] * px + a[i, 1] * py + a[i, 2] for i in range(3)]
    quad = ((m[2] > 1e-6) & (m[0] >= 0) & (m[0] <= (w - 1) * m[2])
            & (m[1] >= 0) & (m[1] <= (h - 1) * m[2]))
    valid = (quad & (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
             & depth_ok[:, None, None])
    ad = jnp.where(valid, jnp.abs(warped - ref.astype(f32)[None]), 0.0)
    adp = jnp.pad(ad, ((0, 0), (1, 1), (1, 1)), mode="edge")
    cost = sum(adp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)) / 9.0
    return jnp.moveaxis(cost, 0, -1), jnp.moveaxis(valid, 0, -1)
