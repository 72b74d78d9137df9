"""Visual-inertial initialization: gyro-bias calibration and linear
gravity / velocity / scale alignment.

The reference's agent estimator is a VINS-Mono-class VIO whose configs
(`/root/reference/config/euroc/euroc_config.yaml:44-63`) presume the standard
VINS bootstrap: visual structure-from-motion gives up-to-scale poses, then
(1) gyro bias is calibrated by matching visual relative rotations against
IMU preintegrated rotations, and (2) a linear system recovers per-keyframe
velocity, the gravity direction, and metric scale. This module supplies both
steps as fixed-shape masked least squares, one jitted solve each —
no RANSAC loops, no incremental factorization.

Inputs are body-frame window poses (any consistent up-to-scale frame) and the
stacked `Preintegrated` deltas between consecutive keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import quat_inverse, quat_multiply, quat_to_matrix
from .imu import Preintegrated

__all__ = ["calibrate_gyro_bias", "linear_alignment", "AlignmentResult"]


class AlignmentResult(NamedTuple):
    scale: jax.Array     # () metric scale of the visual positions
    gravity: jax.Array   # (3,) gravity vector in the visual world frame
    v: jax.Array         # (K, 3) world-frame velocities
    ok: jax.Array        # () bool: system well-conditioned & scale positive
    g_free_norm: jax.Array = jnp.asarray(9.81)  # () |g| of the FREE solve —
    # the VINS-Mono quality gate (`fabs(g.norm() - G.norm()) > 1.0` fails
    # initialization) before gravity is projected onto the 9.81 sphere


@jax.jit
def calibrate_gyro_bias(q_wb: jax.Array, pre: Preintegrated,
                        valid: jax.Array) -> jax.Array:
    """Gyro bias from visual vs preintegrated relative rotations.

    q_wb: (K, 4) visual body orientations; pre: stacked (K-1, ...)
    preintegrations at their linearization biases; valid: (K-1,) bool.
    Solves min_δbg Σ ‖2 vec(γ_k(bg)⁻¹ ⊗ (q_k⁻¹ ⊗ q_{k+1}))‖² linearized at
    the preintegration bias (the VINS `solveGyroscopeBias` normal equations).
    Returns the corrected bias bg = bg_lin + δbg (weighted mean of per-edge
    linearization biases for the lin point).
    """
    q_rel = jax.vmap(lambda a, b: quat_multiply(quat_inverse(a), b))(
        q_wb[:-1], q_wb[1:])                              # (K-1, 4) visual

    def one(dq, j_q_bg, qr, ok):
        err = quat_multiply(quat_inverse(dq), qr)
        r = 2.0 * err[1:] * jnp.sign(err[0])              # small-angle vec
        a = j_q_bg
        w = jnp.where(ok, 1.0, 0.0)
        return w * (a.T @ a), w * (a.T @ r)

    ata, atb = jax.vmap(one)(pre.dq, pre.j_q_bg, q_rel, valid)
    h = jnp.sum(ata, axis=0) + 1e-8 * jnp.eye(3)
    dbg = jnp.linalg.solve(h, jnp.sum(atb, axis=0))
    w = valid.astype(jnp.float32)
    bg_lin = jnp.sum(pre.bg * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    return bg_lin + dbg


def _alignment_system(p_vis, q_wb, pre, valid, k):
    """Masked normal equations for x = [v_0..v_{K-1} (3K), g (3), s (1)].

    Per interval k (VINS `LinearAlignment`, world-frame form):
      s·(p̄_{k+1} − p̄_k) = v_k Δt + ½ g Δt² + R_k Δp_k
      v_{k+1} − v_k = g Δt + R_k Δv_k
    """
    n = 3 * k + 4

    def one(i):
        dt = pre.dt[i]
        r_k = quat_to_matrix(q_wb[i])
        dp_obs = r_k @ pre.dp[i]
        dv_obs = r_k @ pre.dv[i]
        # 6 rows: [position eq (3); velocity eq (3)]
        a = jnp.zeros((6, n))
        eye = jnp.eye(3)
        a = jax.lax.dynamic_update_slice(a, -dt * eye, (0, 3 * i))        # v_k
        a = a.at[0:3, 3 * k:3 * k + 3].set(-0.5 * dt * dt * eye)          # g
        a = a.at[0:3, 3 * k + 3].set(p_vis[i + 1] - p_vis[i])             # s
        a = jax.lax.dynamic_update_slice(a, -eye, (3, 3 * i))             # v_k
        a = jax.lax.dynamic_update_slice(a, eye, (3, 3 * (i + 1)))        # v_k+1
        a = a.at[3:6, 3 * k:3 * k + 3].set(-dt * eye)                     # g
        b = jnp.concatenate([dp_obs, dv_obs])
        w = jnp.where(valid[i], 1.0, 0.0)
        return w * (a.T @ a), w * (a.T @ b)

    ata, atb = jax.vmap(one)(jnp.arange(k - 1))
    return jnp.sum(ata, axis=0), jnp.sum(atb, axis=0)


@jax.jit
def linear_alignment(p_vis: jax.Array, q_wb: jax.Array, pre: Preintegrated,
                     valid: jax.Array,
                     gravity_mag: float = 9.81) -> AlignmentResult:
    """Velocity / gravity / scale from up-to-scale visual poses + IMU.

    p_vis: (K, 3) up-to-scale body positions; q_wb: (K, 4) body orientations
    (rotation is metric from vision); pre: stacked (K-1, ...) preintegrations;
    valid: (K-1,) bool. Two-stage: free-gravity linear solve, then gravity
    refined on the ‖g‖ = 9.81 sphere (2-DoF tangent re-solve, the VINS
    `RefineGravity` step). The visual frame is NOT rotated here — callers
    rotate world so g → (0,0,−9.81) if they want gravity-aligned output.
    """
    k = p_vis.shape[0]
    n = 3 * k + 4
    ata, atb = _alignment_system(p_vis, q_wb, pre, valid, k)
    # weak regularization keeps unobserved velocity blocks (invalid
    # intervals) finite without biasing the rest
    h = ata + 1e-6 * jnp.eye(n)
    x = jnp.linalg.solve(h, atb)
    g0 = x[3 * k:3 * k + 3]

    # refine on the sphere: g = m·ĝ + B(ĝ) w, w ∈ R², iterate basis
    def refine(g, _):
        ghat = g / jnp.maximum(jnp.linalg.norm(g), 1e-9)
        tmp = jnp.where(jnp.abs(ghat[2]) < 0.9,
                        jnp.asarray([0.0, 0.0, 1.0]),
                        jnp.asarray([1.0, 0.0, 0.0]))
        b1 = jnp.cross(ghat, tmp)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-9)
        b2 = jnp.cross(ghat, b1)
        bmat = jnp.stack([b1, b2], axis=1)                    # (3, 2)
        # substitute g = m ĝ + B w into the normal equations:
        # variables y = [v (3K), w (2), s (1)]
        t = jnp.zeros((n, n - 1))
        t = t.at[:3 * k, :3 * k].set(jnp.eye(3 * k))
        t = t.at[3 * k:3 * k + 3, 3 * k:3 * k + 2].set(bmat)
        t = t.at[3 * k + 3, 3 * k + 2].set(1.0)
        c = jnp.zeros(n).at[3 * k:3 * k + 3].set(gravity_mag * ghat)
        h_y = t.T @ h @ t
        b_y = t.T @ (atb - ata @ c)
        y = jnp.linalg.solve(h_y + 1e-8 * jnp.eye(n - 1), b_y)
        g_new = gravity_mag * ghat + bmat @ y[3 * k:3 * k + 2]
        return g_new, y

    g_ref, y = jax.lax.scan(refine, g0, None, length=4)
    v = y[-1][:3 * k].reshape(k, 3)
    s = y[-1][3 * k + 2]
    ok = (s > 1e-3) & jnp.isfinite(s) & (jnp.sum(valid) >= 3)
    return AlignmentResult(scale=s, gravity=g_ref, v=v, ok=ok,
                           g_free_norm=jnp.linalg.norm(g0))
