"""Pinhole + radial-tangential camera model, batched and jit-friendly.

Batched equivalent of the reference's `ServerCamera`
(`/root/reference/server_pose_graph/src/server_camera.cpp:21-121`) and the
camodocal `PinholeCamera` (`/root/reference/camera_model/...`): a plain pytree
of intrinsics with vectorized project / lift operations. The iterative
undistortion mirrors the reference's 8-iteration recursive scheme
(`server_camera.cpp:21-59`) but runs on whole point batches at once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["PinholeCamera", "distort", "undistort_iterative"]


class PinholeCamera(NamedTuple):
    """fx, fy, cx, cy scalars; dist = (k1, k2, p1, p2)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    dist: jax.Array  # (4,)
    width: int = 752
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), width=752, height=480,
               dtype=jnp.float32) -> "PinholeCamera":
        return PinholeCamera(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            jnp.asarray(dist, dtype), int(width), int(height),
        )

    @property
    def k_matrix(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack([
            jnp.stack([self.fx, z, self.cx]),
            jnp.stack([z, self.fy, self.cy]),
            jnp.stack([z, z, o]),
        ])

    def project(self, pts_cam: jax.Array) -> jax.Array:
        """Camera-frame 3D points (..., 3) -> distorted pixel coords (..., 2).

        Mirrors `ServerCamera::Project` (`server_camera.cpp:70-103`).
        """
        z = pts_cam[..., 2:3]
        norm = pts_cam[..., :2] / jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
        dn = norm + distort(norm, self.dist)
        return jnp.stack(
            [self.fx * dn[..., 0] + self.cx, self.fy * dn[..., 1] + self.cy], axis=-1
        )

    def project_normalized(self, norm: jax.Array) -> jax.Array:
        """Normalized (undistorted) coords (..., 2) -> distorted pixels."""
        dn = norm + distort(norm, self.dist)
        return jnp.stack(
            [self.fx * dn[..., 0] + self.cx, self.fy * dn[..., 1] + self.cy], axis=-1
        )

    def lift(self, px: jax.Array, iters: int = 8) -> jax.Array:
        """Pixel coords (..., 2) -> undistorted normalized coords (..., 2).

        Mirrors `ServerCamera::LiftProject` (`server_camera.cpp:21-59`):
        fixed-count recursive undistortion (jit-stable).
        """
        pd = jnp.stack(
            [(px[..., 0] - self.cx) / self.fx, (px[..., 1] - self.cy) / self.fy],
            axis=-1,
        )
        return undistort_iterative(pd, self.dist, iters)

    def lift_to_ray(self, px: jax.Array, iters: int = 8) -> jax.Array:
        """Pixels -> unit-z rays (..., 3)."""
        n = self.lift(px, iters)
        return jnp.concatenate([n, jnp.ones_like(n[..., :1])], axis=-1)

    def in_view(self, px: jax.Array, margin: float = 0.0) -> jax.Array:
        """Boolean mask (...,) of pixels inside the image bounds."""
        return (
            (px[..., 0] >= margin)
            & (px[..., 0] <= self.width - 1 - margin)
            & (px[..., 1] >= margin)
            & (px[..., 1] <= self.height - 1 - margin)
        )


def distort(norm: jax.Array, dist: jax.Array) -> jax.Array:
    """Additive radial-tangential distortion term d(p) with p normalized.

    Same polynomial as `ServerCamera::Distortion` (`server_camera.cpp:105-121`).
    """
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = norm[..., 0], norm[..., 1]
    mx2 = x * x
    my2 = y * y
    mxy = x * y
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = x * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
    dy = y * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
    return jnp.stack([dx, dy], axis=-1)


def undistort_iterative(pd: jax.Array, dist: jax.Array, iters: int = 8) -> jax.Array:
    """Invert `distort` by fixed-point iteration: u_{k+1} = pd - d(u_k)."""
    u = pd
    for _ in range(iters):
        u = pd - distort(u, dist)
    return u
