"""4-DoF (yaw + translation) pose-graph optimizer, matrix-free Gauss-Newton.

Array-program replacement for the reference's Ceres problem
(`/root/reference/server_pose_graph/src/server_pose_graph.cpp:1430-1706`):
per-keyframe yaw (angle-wrapped) + translation blocks, pitch/roll frozen from
VIO, sequential edges to up to 6 same-client predecessors
(`:1527-1581`), weighted loop edges with Huber(0.1) (`:1608-1643`).

Instead of a sparse Cholesky on a host CPU, the normal equations are solved
matrix-free: residuals and hand-coded edge Jacobians are evaluated for all
edges at once (gathers over node arrays), H·v products are two batched
edge-sweeps plus a segment-sum scatter, and the linear solve is Jacobi-
preconditioned conjugate gradients inside an LM loop — every piece is a
fixed-shape array program that shards over the edge/node axes
(`jax.sharding`) for multi-chip scale-out.

Cost semantics mirror `FourDOFError` / `FourDOFWeightError`
(`server_pose_graph.h:313-401`): translation residual in frame i, yaw
residual in degrees-equivalent weighting (loop edges: t weight 1, yaw
weight 0.1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import wrap_angle, ypr_to_r

__all__ = ["PoseGraphNodes", "PoseGraphEdges", "optimize_pose_graph",
           "edge_residuals", "make_sequential_edges"]


class PoseGraphNodes(NamedTuple):
    yaw: jax.Array      # (N,) radians
    pr: jax.Array       # (N, 2) frozen (pitch, roll) radians
    t: jax.Array        # (N, 3)
    valid: jax.Array    # (N,) bool
    fixed: jax.Array    # (N,) bool — gauge: first client's first KF


class PoseGraphEdges(NamedTuple):
    """Relative 4-DoF constraints i -> j (t_ij in frame i, yaw_ij)."""

    i: jax.Array        # (E,) int32
    j: jax.Array        # (E,) int32
    t_ij: jax.Array     # (E, 3)
    yaw_ij: jax.Array   # (E,)
    t_weight: jax.Array  # (E,)
    yaw_weight: jax.Array  # (E,)
    valid: jax.Array    # (E,) bool
    huber: jax.Array    # (E,) huber delta (inf => quadratic)


def _rot_i(yaw, pr):
    return ypr_to_r(jnp.stack([yaw, pr[..., 0], pr[..., 1]], axis=-1))


def _drot_dyaw(yaw, pr):
    """d R(yaw,p,r) / d yaw = dRz/dyaw Ry Rx."""
    eps_rot = ypr_to_r(jnp.stack([jnp.zeros_like(yaw), pr[..., 0], pr[..., 1]], axis=-1))
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(yaw)
    drz = jnp.stack([-s, -c, z, c, -s, z, z, z, z], axis=-1).reshape(yaw.shape + (3, 3))
    return drz @ eps_rot


def edge_residuals(nodes: PoseGraphNodes, edges: PoseGraphEdges) -> jax.Array:
    """(E, 4) whitened residuals [t(3), yaw] with Huber scaling."""
    yaw_i = nodes.yaw[edges.i]
    pr_i = nodes.pr[edges.i]
    t_i = nodes.t[edges.i]
    t_j = nodes.t[edges.j]
    yaw_j = nodes.yaw[edges.j]
    r_i = _rot_i(yaw_i, pr_i)
    rt = jnp.einsum("eij,ei->ej", r_i, t_j - t_i) - edges.t_ij
    ry = wrap_angle(yaw_j - yaw_i - edges.yaw_ij)
    r = jnp.concatenate([rt * edges.t_weight[:, None],
                         (ry * edges.yaw_weight)[:, None]], axis=-1)
    ok = edges.valid & nodes.valid[edges.i] & nodes.valid[edges.j]
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    # branch-free Huber sqrt-weight (no inf/rn: keeps autodiff NaN-free)
    w = jnp.where(rn > edges.huber[:, None],
                  jnp.sqrt(edges.huber[:, None] / jnp.maximum(rn, 1e-12)), 1.0)
    return jnp.where(ok[:, None], r * w, 0.0)


def _edge_jacobians(nodes: PoseGraphNodes, edges: PoseGraphEdges):
    """Analytic Jacobians of the *unweighted, un-Hubered* residual.

    Returns (jt_ti (E,3,3), jt_tj, jt_yi (E,3)): translation-residual blocks;
    yaw-residual blocks are constant (-1 on yaw_i, +1 on yaw_j).
    Huber/weights/validity are applied by the caller as row scales (Huber
    treated as constant per LM step — standard IRLS approximation).
    """
    yaw_i = nodes.yaw[edges.i]
    pr_i = nodes.pr[edges.i]
    r_i = _rot_i(yaw_i, pr_i)
    dr = _drot_dyaw(yaw_i, pr_i)
    dt = nodes.t[edges.j] - nodes.t[edges.i]
    jt_tj = jnp.swapaxes(r_i, -1, -2)          # d rt / d t_j = R_i^T
    jt_ti = -jt_tj
    jt_yi = jnp.einsum("eji,ej->ei", dr, dt)    # d (R_i^T dt) / d yaw_i = (dR/dyaw)^T dt
    return jt_ti, jt_tj, jt_yi


def _row_scales(nodes: PoseGraphNodes, edges: PoseGraphEdges):
    """Per-edge IRLS row scales: (E,) for t-rows and yaw-row, including
    validity, weights and frozen-Huber scaling."""
    r = edge_residuals(nodes, edges)  # already weighted+hubered; recompute w
    ok = edges.valid & nodes.valid[edges.i] & nodes.valid[edges.j]
    # recompute huber weight on the weighted residual norm
    yaw_i = nodes.yaw[edges.i]
    r_i = _rot_i(yaw_i, nodes.pr[edges.i])
    rt = jnp.einsum("eij,ei->ej", r_i, nodes.t[edges.j] - nodes.t[edges.i]) - edges.t_ij
    ry = wrap_angle(nodes.yaw[edges.j] - yaw_i - edges.yaw_ij)
    rw = jnp.concatenate([rt * edges.t_weight[:, None], (ry * edges.yaw_weight)[:, None]], -1)
    rn = jnp.linalg.norm(rw, axis=-1)
    hw = jnp.where(rn > edges.huber,
                   jnp.sqrt(edges.huber / jnp.maximum(rn, 1e-12)), 1.0)
    scale_t = jnp.where(ok, edges.t_weight * hw, 0.0)
    scale_y = jnp.where(ok, edges.yaw_weight * hw, 0.0)
    return scale_t, scale_y


def _jvp(nodes, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, dyaw, dt):
    """J @ [dyaw, dt] -> (E, 4) residual-space vector."""
    d_ti = dt[edges.i]
    d_tj = dt[edges.j]
    d_yi = dyaw[edges.i]
    d_yj = dyaw[edges.j]
    rt = (jnp.einsum("eij,ej->ei", jt_ti, d_ti)
          + jnp.einsum("eij,ej->ei", jt_tj, d_tj)
          + jt_yi * d_yi[:, None]) * scale_t[:, None]
    ry = (d_yj - d_yi) * scale_y
    return jnp.concatenate([rt, ry[:, None]], axis=-1)


def _vjp(nodes, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, r, n_nodes):
    """J^T @ r -> (dyaw (N,), dt (N, 3)) via segment sums."""
    rt = r[:, :3] * scale_t[:, None]
    ry = r[:, 3] * scale_y
    gt_i = jnp.einsum("eji,ej->ei", jt_ti, rt)
    gt_j = jnp.einsum("eji,ej->ei", jt_tj, rt)
    gy_i = jnp.einsum("ei,ei->e", jt_yi, rt) - ry
    gy_j = ry
    dt_out = (jax.ops.segment_sum(gt_i, edges.i, n_nodes)
              + jax.ops.segment_sum(gt_j, edges.j, n_nodes))
    dyaw_out = (jax.ops.segment_sum(gy_i, edges.i, n_nodes)
                + jax.ops.segment_sum(gy_j, edges.j, n_nodes))
    return dyaw_out, dt_out


def optimize_pose_graph(nodes: PoseGraphNodes, edges: PoseGraphEdges,
                        lm_iters: int = 12, cg_iters: int = 50,
                        init_lambda: float = 1e-4) -> PoseGraphNodes:
    """LM with Jacobi-preconditioned CG on the 4-DoF graph.

    Fixed/invalid nodes get unit diagonal and zero updates. Plays the role of
    `ceres::Solve` with SPARSE_NORMAL_CHOLESKY / 20 iterations
    (`server_pose_graph.cpp:1450-1451,1706`).
    """
    n = nodes.yaw.shape[0]
    free = nodes.valid & ~nodes.fixed

    def total_cost(nd):
        return 0.5 * jnp.sum(edge_residuals(nd, edges) ** 2)

    def lm_step(carry, _):
        nd, lam, cost = carry
        jt_ti, jt_tj, jt_yi = _edge_jacobians(nd, edges)
        scale_t, scale_y = _row_scales(nd, edges)
        r = edge_residuals(nd, edges)

        g_yaw, g_t = _vjp(nd, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, r, n)
        g_yaw = jnp.where(free, g_yaw, 0.0)
        g_t = jnp.where(free[:, None], g_t, 0.0)

        # Jacobi preconditioner: diag(J^T J) per node from edge blocks
        st2 = scale_t ** 2
        sy2 = scale_y ** 2
        d_t = (jax.ops.segment_sum(jnp.einsum("eij,eij->ej", jt_ti, jt_ti) * st2[:, None], edges.i, n)
               + jax.ops.segment_sum(jnp.einsum("eij,eij->ej", jt_tj, jt_tj) * st2[:, None], edges.j, n))
        d_yaw = (jax.ops.segment_sum((jnp.sum(jt_yi ** 2, -1) * st2 + sy2), edges.i, n)
                 + jax.ops.segment_sum(sy2, edges.j, n))
        d_t = jnp.where(free[:, None], d_t, 1.0) + 1e-8
        d_yaw = jnp.where(free, d_yaw, 1.0) + 1e-8

        lam_d_t = d_t * (1.0 + lam)
        lam_d_yaw = d_yaw * (1.0 + lam)

        def hvp(dyaw, dt):
            dyaw = jnp.where(free, dyaw, 0.0)
            dt = jnp.where(free[:, None], dt, 0.0)
            jv = _jvp(nd, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, dyaw, dt)
            hy, ht = _vjp(nd, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, jv, n)
            hy = jnp.where(free, hy + lam * d_yaw * dyaw, 0.0)
            ht = jnp.where(free[:, None], ht + lam * d_t * dt, 0.0)
            return hy, ht

        # PCG solve H dx = -g
        def dot(a, b):
            return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

        b = (-g_yaw, -g_t)
        x = (jnp.zeros_like(g_yaw), jnp.zeros_like(g_t))
        rr = b
        z = (rr[0] / lam_d_yaw, rr[1] / lam_d_t)
        p = z
        rz = dot(rr, z)

        def cg_body(_, st):
            x, rr, p, rz = st
            hp = hvp(*p)
            denom = dot(p, hp)
            alpha = rz / jnp.maximum(denom, 1e-20)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            rr = (rr[0] - alpha * hp[0], rr[1] - alpha * hp[1])
            z = (rr[0] / lam_d_yaw, rr[1] / lam_d_t)
            rz_new = dot(rr, z)
            beta = rz_new / jnp.maximum(rz, 1e-20)
            p = (z[0] + beta * p[0], z[1] + beta * p[1])
            return x, rr, p, rz_new

        x, rr, p, rz = jax.lax.fori_loop(0, cg_iters, cg_body, (x, rr, p, rz))
        dyaw, dt = x
        nd_new = nd._replace(yaw=wrap_angle(nd.yaw + jnp.where(free, dyaw, 0.0)),
                             t=nd.t + jnp.where(free[:, None], dt, 0.0))
        cost_new = total_cost(nd_new)
        accept = cost_new < cost
        pred = -dot((g_yaw, g_t), x) * 0.5  # rough model reduction proxy
        nd_out = jax.tree_util.tree_map(lambda a, b_: jnp.where(accept, a, b_), nd_new, nd)
        lam_out = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-9),
                            jnp.minimum(lam * 4.0, 1e6))
        return (nd_out, lam_out, jnp.where(accept, cost_new, cost)), cost

    cost0 = total_cost(nodes)
    (nodes_f, _, _), _ = jax.lax.scan(
        lm_step, (nodes, jnp.asarray(init_lambda, nodes.t.dtype), cost0),
        None, length=lm_iters)
    return nodes_f


def make_sequential_edges(yaw, pr, t, client_id, valid, max_back: int = 6,
                          t_weight: float = 1.0, yaw_weight: float = 1.0):
    """Build the reference's sequential odometry edges: each node connects to
    up to `max_back` same-client predecessors (`server_pose_graph.cpp:1527-1581`),
    with measurements taken from the *current* (VIO/world) poses.

    Returns a PoseGraphEdges of shape (N * max_back,).
    """
    n = yaw.shape[0]
    idx = jnp.arange(n)
    js = jnp.repeat(idx, max_back)
    backs = jnp.tile(jnp.arange(1, max_back + 1), n)
    is_ = js - backs
    ok = (is_ >= 0) & valid[js] & valid[jnp.clip(is_, 0, n - 1)]
    is_c = jnp.clip(is_, 0, n - 1)
    ok = ok & (client_id[js] == client_id[is_c])
    r_i = _rot_i(yaw[is_c], pr[is_c])
    t_ij = jnp.einsum("eij,ei->ej", r_i, t[js] - t[is_c])
    yaw_ij = wrap_angle(yaw[js] - yaw[is_c])
    e = n * max_back
    return PoseGraphEdges(
        i=is_c.astype(jnp.int32), j=js.astype(jnp.int32),
        t_ij=t_ij, yaw_ij=yaw_ij,
        t_weight=jnp.full(e, t_weight, yaw.dtype),
        yaw_weight=jnp.full(e, yaw_weight, yaw.dtype),
        valid=ok, huber=jnp.full(e, jnp.inf, yaw.dtype))
