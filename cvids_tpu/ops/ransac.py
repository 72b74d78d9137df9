"""Batched-hypothesis RANSAC kernels: PnP and fundamental matrix.

The reference verifies loop-closure candidates with `cv::findFundamentalMat`
(`/root/reference/server_pose_graph/src/server_keyframe.cpp:382-413`) and
`cv::solvePnPRansac` on normalized coordinates with identity K
(`server_keyframe.cpp:418-497`). Data-dependent RANSAC loops don't jit, so
both are re-designed as *fixed-shape hypothesis sweeps*: sample all K minimal
sets up front, solve them all in one batched linear-algebra pass, score all
hypotheses against all points with one matrix of residuals, and pick the
argmax — the fixed-shape formulation (SURVEY.md §7 "hard parts" #2).

All functions operate on normalized (undistorted) image coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import matrix_to_quat, quat_to_matrix, so3_exp, so3_hat

__all__ = ["pnp_ransac", "fundamental_ransac", "essential_pose", "PnPResult",
           "FResult", "EPoseResult", "refine_pose_gn"]


class PnPResult(NamedTuple):
    q: jax.Array          # (4,) world->camera rotation (w,x,y,z) — as matrix R_cw
    r: jax.Array          # (3, 3) rotation R_cw
    t: jax.Array          # (3,)   t_cw:  x_cam = R_cw x_world + t_cw
    inliers: jax.Array    # (N,) bool
    num_inliers: jax.Array
    ok: jax.Array         # bool: enough inliers (reference gate: >= 15)


class FResult(NamedTuple):
    f: jax.Array          # (3, 3)
    inliers: jax.Array    # (N,) bool
    num_inliers: jax.Array


def _sample_indices(key: jax.Array, num_hyp: int, sample_size: int,
                    n: int, valid: jax.Array) -> jax.Array:
    """(num_hyp, sample_size) indices drawn with probability ∝ valid.

    Gumbel-top-k per hypothesis: no replacement within a hypothesis.
    """
    logits = jnp.where(valid, 0.0, -1e9)
    g = jax.random.gumbel(key, (num_hyp, n)) + logits[None]
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


def _dlt_pose(pts3d: jax.Array, obs: jax.Array) -> tuple[jax.Array, jax.Array]:
    """6-point DLT for [R|t] from world points and normalized observations.

    pts3d: (S, 3), obs: (S, 2) normalized coords. Returns (R (3,3), t (3,)).
    Solves for P = [R|t] up to scale via the nullspace of the 2S×12 system,
    then projects R onto SO(3) (SVD) and fixes scale/sign with cheirality.
    """
    s = pts3d.shape[0]
    x, y = obs[:, 0], obs[:, 1]
    xh = jnp.concatenate([pts3d, jnp.ones((s, 1), pts3d.dtype)], axis=1)  # (S,4)
    zeros = jnp.zeros_like(xh)
    rows_x = jnp.concatenate([xh, zeros, -x[:, None] * xh], axis=1)  # (S, 12)
    rows_y = jnp.concatenate([zeros, xh, -y[:, None] * xh], axis=1)
    a = jnp.concatenate([rows_x, rows_y], axis=0)  # (2S, 12)
    # nullspace: eigvector of A^T A with smallest eigenvalue
    ata = a.T @ a
    w, v = jnp.linalg.eigh(ata)
    p = v[:, 0].reshape(3, 4)
    r_raw, t_raw = p[:, :3], p[:, 3]
    # scale: ||R|| should have unit singular values
    u, sv, vt = jnp.linalg.svd(r_raw)
    scale = jnp.mean(sv)
    r = u @ vt
    det = jnp.linalg.det(r)
    # fix improper rotation (reflection)
    u_fix = u * jnp.asarray([1.0, 1.0, -1.0])
    r = jnp.where(det < 0, u_fix @ vt, r)
    t = t_raw / jnp.where(jnp.abs(scale) > 1e-12, scale, 1e-12)
    t = jnp.where(det < 0, -t, t)
    # cheirality: majority of points should be in front
    z = (pts3d @ r.T + t)[:, 2]
    flip = jnp.sum(jnp.sign(z)) < 0
    r = jnp.where(flip, -r, r)  # note: -R is improper; handled by scoring (bad hyp dies)
    t = jnp.where(flip, -t, t)
    return r, t


def _reproj_residuals(r, t, pts3d, obs):
    pc = pts3d @ r.T + t
    z = pc[:, 2]
    proj = pc[:, :2] / jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)[:, None]
    err = jnp.linalg.norm(proj - obs, axis=-1)
    return jnp.where(z > 1e-6, err, jnp.inf)


def pnp_ransac(pts3d: jax.Array, obs: jax.Array, valid: jax.Array,
               key: jax.Array, num_hyp: int = 128, sample_size: int = 6,
               inlier_thresh: float = 10.0 / 460.0, min_inliers: int = 15,
               refine_iters: int = 5) -> PnPResult:
    """RANSAC PnP on normalized coordinates.

    Mirrors the reference's `PnPRANSAC` (`server_keyframe.cpp:418-497`):
    threshold ≈ 10 px at focal 460 on normalized coords, accept if ≥
    `min_inliers` (MIN_LOOP_NUM=15, `server_keyframe.h:24-27`). Hypotheses are
    6-point DLT poses, refined by masked Gauss-Newton on all inliers.
    """
    n = pts3d.shape[0]
    idx = _sample_indices(key, num_hyp, sample_size, n, valid)  # (K, S)
    sets3d = pts3d[idx]  # (K, S, 3)
    setsobs = obs[idx]

    rs, ts = jax.vmap(_dlt_pose)(sets3d, setsobs)  # (K,3,3), (K,3)
    errs = jax.vmap(lambda r, t: _reproj_residuals(r, t, pts3d, obs))(rs, ts)  # (K, N)
    inl = (errs < inlier_thresh) & valid[None]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    r0, t0 = rs[best], ts[best]
    inliers0 = inl[best]

    # GN refinement on inlier set (fixed iterations, masked)
    r, t = refine_pose_gn(r0, t0, pts3d, obs, inliers0, iters=refine_iters)
    err_final = _reproj_residuals(r, t, pts3d, obs)
    inliers = (err_final < inlier_thresh) & valid
    num = jnp.sum(inliers)
    return PnPResult(matrix_to_quat(r), r, t, inliers, num, num >= min_inliers)


def refine_pose_gn(r0, t0, pts3d, obs, weight_mask, iters: int = 5):
    """Gauss-Newton refinement of (R, t) minimizing masked reprojection error.

    Left-multiplicative SO(3) update: R <- exp(dw) R.
    """
    mask = weight_mask.astype(pts3d.dtype)

    def step(carry, _):
        r, t = carry
        pc = pts3d @ r.T + t  # (N, 3)
        z = jnp.where(jnp.abs(pc[:, 2]) > 1e-9, pc[:, 2], 1e-9)
        proj = pc[:, :2] / z[:, None]
        res = (proj - obs) * mask[:, None]  # (N, 2)
        inv_z = 1.0 / z
        # d proj / d pc
        j_proj = jnp.stack([
            jnp.stack([inv_z, jnp.zeros_like(inv_z), -pc[:, 0] * inv_z * inv_z], -1),
            jnp.stack([jnp.zeros_like(inv_z), inv_z, -pc[:, 1] * inv_z * inv_z], -1),
        ], axis=1)  # (N, 2, 3)
        # d pc / d [dw, dt] = [-hat(pc), I]
        j_pose = jnp.concatenate([-so3_hat(pc), jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:1] + (3, 3))], axis=2)  # (N, 3, 6)
        j = jnp.einsum("nij,njk->nik", j_proj, j_pose) * mask[:, None, None]  # (N, 2, 6)
        jt = j.reshape(-1, 6)
        h = jt.T @ jt + 1e-8 * jnp.eye(6, dtype=jt.dtype)
        g = jt.T @ res.reshape(-1)
        dx = jnp.linalg.solve(h, -g)
        r_upd = quat_to_matrix(so3_exp(dx[:3])) @ r
        return (r_upd, t + dx[3:]), None

    (r, t), _ = jax.lax.scan(step, (r0, t0), None, length=iters)
    return r, t


def _eight_point(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Normalized 8-point algorithm on (S>=8, 2) correspondences -> F (3,3)."""
    def normalize(p):
        c = jnp.mean(p, axis=0)
        d = jnp.mean(jnp.linalg.norm(p - c, axis=1))
        s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-9)
        tm = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]) * s
        tm = tm.at[2, 2].set(1.0).at[0, 2].set(-s * c[0]).at[1, 2].set(-s * c[1])
        return (p - c) * s, tm

    n1, t1 = normalize(p1)
    n2, t2 = normalize(p2)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    a = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)  # (S, 9)
    _, v = jnp.linalg.eigh(a.T @ a)
    f = v[:, 0].reshape(3, 3)
    # rank-2 projection
    u, s, vt = jnp.linalg.svd(f)
    f2 = (u * jnp.asarray([s[0], s[1], 0.0])) @ vt
    return t2.T @ f2 @ t1


def _sampson_error(f: jax.Array, p1: jax.Array, p2: jax.Array) -> jax.Array:
    h1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)
    h2 = jnp.concatenate([p2, jnp.ones_like(p2[:, :1])], axis=1)
    fx1 = h1 @ f.T   # (N, 3) = F x1
    ftx2 = h2 @ f    # (N, 3) = F^T x2
    num = jnp.sum(h2 * fx1, axis=1) ** 2
    den = fx1[:, 0] ** 2 + fx1[:, 1] ** 2 + ftx2[:, 0] ** 2 + ftx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


class EPoseResult(NamedTuple):
    r: jax.Array           # (3, 3) R_c1<-c0
    t: jax.Array           # (3,) unit translation, cam1 frame
    inliers: jax.Array     # (N,) bool (epipolar inliers)
    num_pos: jax.Array     # cheirality votes of the winning decomposition
    ok: jax.Array


def _two_view_depths(r: jax.Array, t: jax.Array, p0: jax.Array,
                     p1: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-point depths (z0, z1) for cam0 rays p0 and cam1 rays p1 under
    x1*z1 = R x0*z0 + t — 2-unknown least squares per correspondence."""
    x0 = jnp.concatenate([p0, jnp.ones_like(p0[:, :1])], axis=1)  # (N,3)
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)
    a0 = x0 @ r.T                                  # (N,3) = R x0
    # minimize |a0*z0 - x1*z1 + t|^2 over (z0, z1)
    aa = jnp.sum(a0 * a0, 1)
    bb = jnp.sum(x1 * x1, 1)
    ab = jnp.sum(a0 * x1, 1)
    a_t = jnp.sum(a0 * t[None], 1)
    b_t = jnp.sum(x1 * t[None], 1)
    det = aa * bb - ab * ab
    z0 = (-a_t * bb + ab * b_t) / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    z1 = (-a_t * ab + aa * b_t) / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    return z0, z1


@jax.jit
def essential_pose(p0: jax.Array, p1: jax.Array, valid: jax.Array,
                   key: jax.Array) -> EPoseResult:
    """Relative camera pose from 2-view normalized correspondences.

    RANSAC essential matrix (normalized coords make F = E) + the standard
    four-fold decomposition with a cheirality vote — the `cv::recoverPose`
    role, used as the pre-VI-init visual pose bootstrap (VINS-Mono's SfM
    initialization stage; the reference's agents presume it)."""
    fres = fundamental_ransac(p0, p1, valid, key,
                              inlier_thresh=(1.5 / 460.0) ** 2)
    u, s, vt = jnp.linalg.svd(fres.f)
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    rs = jnp.stack([u @ w @ vt, u @ w.T @ vt])          # (2,3,3)
    ts = jnp.stack([u[:, 2], -u[:, 2]])                  # (2,3)
    mask = fres.inliers & valid

    def votes(r, t):
        z0, z1 = _two_view_depths(r, t, p0, p1)
        return jnp.sum((z0 > 0) & (z1 > 0) & mask)

    cand_r = jnp.stack([rs[0], rs[0], rs[1], rs[1]])
    cand_t = jnp.stack([ts[0], ts[1], ts[0], ts[1]])
    v = jax.vmap(votes)(cand_r, cand_t)
    best = jnp.argmax(v)
    n_in = jnp.sum(mask)
    ok = (v[best] >= 0.7 * jnp.maximum(n_in, 1)) & (n_in >= 8)
    return EPoseResult(cand_r[best], cand_t[best], fres.inliers, v[best], ok)


def fundamental_ransac(p1: jax.Array, p2: jax.Array, valid: jax.Array,
                       key: jax.Array, num_hyp: int = 128,
                       inlier_thresh: float = (3.0 / 460.0) ** 2) -> FResult:
    """RANSAC fundamental matrix on normalized coords.

    Mirrors `FundmantalMatrixRANSAC` (`server_keyframe.cpp:382-413`), which
    uses a 3-px threshold at the virtual focal length.
    """
    n = p1.shape[0]
    idx = _sample_indices(key, num_hyp, 8, n, valid)
    fs = jax.vmap(_eight_point)(p1[idx], p2[idx])  # (K, 3, 3)
    errs = jax.vmap(lambda f: _sampson_error(f, p1, p2))(fs)  # (K, N)
    inl = (errs < inlier_thresh) & valid[None]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    return FResult(fs[best], inl[best], counts[best])
