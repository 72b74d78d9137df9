"""Batched SO(3) / quaternion / Euler utilities.

Batched re-design of the reference's Euler-angle algebra
(`/root/reference/server_pose_graph/include/utility/server_utility.h:70-183`):
everything here is dtype-polymorphic, shape-polymorphic over leading batch
dimensions, and safe under `jax.jit` / `vmap` / `grad`.

Conventions
-----------
* Quaternions are ``(..., 4)`` arrays in ``(w, x, y, z)`` order, Hamilton
  convention, and represent rotations ``R(q) @ v``.
* Rotation matrices are ``(..., 3, 3)``.
* ``ypr`` is yaw-pitch-roll **in radians**, matching the reference's
  ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` decomposition
  (`server_utility.h:158-183` uses degrees; degree helpers are provided for
  parity at the API edge).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "quat_normalize",
    "quat_multiply",
    "quat_conjugate",
    "quat_inverse",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_from_axis_angle",
    "so3_exp",
    "so3_log",
    "so3_hat",
    "r_to_ypr",
    "ypr_to_r",
    "r_to_ypr_deg",
    "ypr_deg_to_r",
    "yaw_of",
    "rot_z",
    "wrap_angle",
    "quat_slerp",
    "g2r",
]


def quat_normalize(q: jax.Array) -> jax.Array:
    """Normalize quaternion(s) to unit norm, keeping w >= 0."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return jnp.where(q[..., :1] < 0, -q, q)


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product q1 ⊗ q2 (applies q2's rotation first)."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_inverse(q: jax.Array) -> jax.Array:
    """Inverse for unit quaternions (== conjugate)."""
    return quat_conjugate(q)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) ``v`` (..., 3) by quaternion(s) ``q`` (..., 4)."""
    qvec = q[..., 1:]
    uv = jnp.cross(qvec, v)
    uuv = jnp.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (w,x,y,z).

    Branchless Shepperd's method: compute all four candidate quaternions and
    select the best-conditioned one (largest pivot) with `where` — safe under
    jit/vmap unlike the classic if-ladder.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (>= 0).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    return quat_normalize(q)


def quat_from_axis_angle(axis: jax.Array, angle: jax.Array) -> jax.Array:
    axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True), 1e-12)
    half = 0.5 * angle[..., None]
    return jnp.concatenate([jnp.cos(half), jnp.sin(half) * axis], axis=-1)


def so3_hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of (..., 3) vectors."""
    wx, wy, wz = jnp.moveaxis(w, -1, 0)
    zeros = jnp.zeros_like(wx)
    m = jnp.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], axis=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: jax.Array) -> jax.Array:
    """Exponential map R^3 -> SO(3) as quaternion (w,x,y,z), Taylor-safe at 0."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-10
    half = 0.5 * theta
    sin_half_over = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    cw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([cw, sin_half_over * w], axis=-1)


def so3_log(q: jax.Array) -> jax.Array:
    """Log map SO(3) (unit quaternion) -> R^3, Taylor-safe at identity."""
    q = jnp.where(q[..., :1] < 0, -q, q)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vec = q[..., 1:]
    sin_half = jnp.linalg.norm(vec, axis=-1, keepdims=True)
    half = jnp.arctan2(sin_half, w)
    small = sin_half < 1e-7
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), 2.0 * half / jnp.maximum(sin_half, 1e-24))
    return scale * vec


def r_to_ypr(m: jax.Array) -> jax.Array:
    """R -> (yaw, pitch, roll) radians; mirrors `server_utility.h:70-85` math."""
    n, o, a = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    yaw = jnp.arctan2(n[..., 1], n[..., 0])
    pitch = jnp.arctan2(-n[..., 2], n[..., 0] * jnp.cos(yaw) + n[..., 1] * jnp.sin(yaw))
    roll = jnp.arctan2(
        a[..., 0] * jnp.sin(yaw) - a[..., 1] * jnp.cos(yaw),
        -o[..., 0] * jnp.sin(yaw) + o[..., 1] * jnp.cos(yaw),
    )
    return jnp.stack([yaw, pitch, roll], axis=-1)


def ypr_to_r(ypr: jax.Array) -> jax.Array:
    """(yaw, pitch, roll) radians -> R = Rz(y) Ry(p) Rx(r); `server_utility.h:158-183`."""
    y, p, r = jnp.moveaxis(ypr, -1, 0)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    m = jnp.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        axis=-1,
    )
    return m.reshape(ypr.shape[:-1] + (3, 3))


def r_to_ypr_deg(m: jax.Array) -> jax.Array:
    return jnp.rad2deg(r_to_ypr(m))


def ypr_deg_to_r(ypr_deg: jax.Array) -> jax.Array:
    return ypr_to_r(jnp.deg2rad(ypr_deg))


def yaw_of(q_or_m: jax.Array) -> jax.Array:
    """Yaw (radians) of a rotation given as quaternion (...,4) or matrix (...,3,3)."""
    m = q_or_m if q_or_m.shape[-1] == 3 else quat_to_matrix(q_or_m)
    return jnp.arctan2(m[..., 1, 0], m[..., 0, 0])


def rot_z(yaw: jax.Array) -> jax.Array:
    """Rz(yaw) for (...,) yaw in radians."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(yaw)
    o = jnp.ones_like(yaw)
    m = jnp.stack([c, -s, z, s, c, z, z, z, o], axis=-1)
    return m.reshape(yaw.shape + (3, 3))


def wrap_angle(a: jax.Array) -> jax.Array:
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * jnp.pi * jnp.floor((a + jnp.pi) / (2.0 * jnp.pi))


def quat_slerp(q0: jax.Array, q1: jax.Array, t: jax.Array) -> jax.Array:
    """Spherical interpolation, shortest arc, safe near q0==q1."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    d = jnp.clip(d, -1.0, 1.0)
    theta = jnp.arccos(d)
    sin_theta = jnp.sin(theta)
    small = sin_theta < 1e-6
    t = jnp.asarray(t)[..., None] if jnp.ndim(t) < jnp.ndim(d) else t
    w0 = jnp.where(small, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.maximum(sin_theta, 1e-12))
    w1 = jnp.where(small, t, jnp.sin(t * theta) / jnp.maximum(sin_theta, 1e-12))
    return quat_normalize(w0 * q0 + w1 * q1)


def g2r(g: jax.Array) -> jax.Array:
    """Gravity-aligning rotation: R @ ĝ = (0,0,1) with zero yaw.

    Mirrors `server_utility.cpp` `g2R` (used by VIO initialization): rotate the
    normalized gravity estimate onto +z, then remove the induced yaw.
    """
    ng1 = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    ng2 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype=g.dtype), ng1.shape)
    axis = jnp.cross(ng1, ng2)
    axis_norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    cosang = jnp.clip(jnp.sum(ng1 * ng2, axis=-1), -1.0, 1.0)
    angle = jnp.arctan2(axis_norm[..., 0], cosang)
    safe_axis = jnp.where(axis_norm > 1e-8, axis / jnp.maximum(axis_norm, 1e-12),
                          jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dtype=g.dtype), ng1.shape))
    r0 = quat_to_matrix(quat_from_axis_angle(safe_axis, angle))
    yaw = yaw_of(r0)
    return rot_z(-yaw) @ r0
