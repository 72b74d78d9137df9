"""Sliding-window visual-inertial bundle adjustment, JAX-native.

The reference relies on an external VINS-Mono-class agent estimator
(SURVEY.md layer A — contract only); this module supplies it, re-designed as an
array program: fixed-capacity state arrays with validity masks (jit-stable shapes), the
whole factor graph evaluated as one batched residual function, Jacobians by
autodiff, and a damped Gauss-Newton (LM) loop as a `lax.scan` with
`where`-selected accept/reject — no data-dependent control flow.

States per keyframe: p, q, v, bg, ba (15 DoF on-manifold); landmarks are 3-D
world points. Factors: masked reprojection (Huber), IMU preintegration
(`imu.imu_residual`), optional linearized prior (from marginalization), and
weak anchors that pin the gauge (first pose + yaw).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..geometry import quat_multiply, quat_normalize, quat_rotate, quat_inverse, so3_exp, quat_to_matrix
from .imu import Preintegrated, imu_residual

__all__ = ["WindowState", "WindowMeasurements", "PriorFactor",
           "CamPriorFactor", "solve_window", "solve_window_schur",
           "solve_window_fast", "triangulate", "reprojection_residuals",
           "marginalize_prior", "marginalize_prior_cam"]


class WindowState(NamedTuple):
    p: jax.Array    # (K, 3)
    q: jax.Array    # (K, 4)
    v: jax.Array    # (K, 3)
    bg: jax.Array   # (K, 3)
    ba: jax.Array   # (K, 3)
    lm: jax.Array   # (L, 3) world landmarks
    kf_valid: jax.Array  # (K,) bool
    lm_valid: jax.Array  # (L,) bool


class PriorFactor(NamedTuple):
    """Linearized prior: r(dx) = j @ dx + r0, dx = state ⊖ x_lin (tangent)."""

    j: jax.Array    # (P, D) sqrt-information Jacobian over the tangent vector
    r0: jax.Array   # (P,)
    # linearization point (same layout as WindowState state fields)
    p: jax.Array
    q: jax.Array
    v: jax.Array
    bg: jax.Array
    ba: jax.Array
    lm: jax.Array


class CamPriorFactor(NamedTuple):
    """Camera-only linearized prior: r(dc) = j @ dc + r0 with dc the 15K
    camera tangent in [dp, dth, dv, dbg, dba] block order (each block K x 3
    row-major) — the `_retract_cam`/Schur layout.

    This is the VINS marginalization design (`marginalization_factor.cpp`):
    features hosted by the marginalized frame are eliminated WITH it and the
    prior spans only pose/velocity/bias blocks. A camera-only prior keeps
    H_ll exactly 3x3 block-diagonal, which is what makes the Schur
    landmark elimination (`solve_window_fast`, the sharded solver) exact.
    """

    j: jax.Array    # (P, 15K)
    r0: jax.Array   # (P,)
    p: jax.Array    # linearization camera states
    q: jax.Array
    v: jax.Array
    bg: jax.Array
    ba: jax.Array


class WindowMeasurements(NamedTuple):
    obs: jax.Array       # (K, L, 2) normalized camera coords
    vis: jax.Array       # (K, L) bool
    pre: Preintegrated   # stacked (K-1, ...) preintegrated IMU factors
    pre_valid: jax.Array  # (K-1,) bool
    r_cb: jax.Array      # (3, 3) body->camera rotation (x_cam = R_cb x_body)
    p_bc: jax.Array      # (3,) camera origin in body frame
    pix_weight: float    # 1 / sigma of normalized-coordinate noise
    huber_delta: float   # Huber threshold on the *whitened* residual norm
    bias_weight: float   # whitening for the bias random-walk residual
    prior: PriorFactor | None
    anchor_p: jax.Array  # (3,) gauge: pin p[0] here
    anchor_yaw: jax.Array  # () gauge: pin yaw of q[0] here
    # weak absolute bias priors (1/sigma). Without a marginalization prior,
    # a free accelerometer bias can absorb the specific-force signal and
    # collapse monocular scale — these bound it to sensor-spec magnitudes.
    ba_prior_weight: float = 10.0   # sigma 0.1 m/s^2
    bg_prior_weight: float = 100.0  # sigma 0.01 rad/s


def _delta_zero(state: WindowState):
    k = state.p.shape[0]
    l = state.lm.shape[0]
    z = jnp.zeros
    dt = state.p.dtype
    return dict(dp=z((k, 3), dt), dth=z((k, 3), dt), dv=z((k, 3), dt),
                dbg=z((k, 3), dt), dba=z((k, 3), dt), dlm=z((l, 3), dt))


def retract(state: WindowState, delta: dict) -> WindowState:
    """Apply a tangent update: q' = q ⊗ Exp(dθ), everything else additive."""
    return state._replace(
        p=state.p + delta["dp"],
        q=quat_normalize(quat_multiply(state.q, so3_exp(delta["dth"]))),
        v=state.v + delta["dv"],
        bg=state.bg + delta["dbg"],
        ba=state.ba + delta["dba"],
        lm=state.lm + delta["dlm"],
    )


def local_diff(state: WindowState, ref_p, ref_q, ref_v, ref_bg, ref_ba, ref_lm):
    """state ⊖ reference as a flat tangent (matches `retract` layout)."""
    from ..geometry import so3_log
    dq = jax.vmap(lambda a, b: so3_log(quat_multiply(quat_inverse(b), a)))(state.q, ref_q)
    delta = dict(dp=state.p - ref_p, dth=dq, dv=state.v - ref_v,
                 dbg=state.bg - ref_bg, dba=state.ba - ref_ba,
                 dlm=state.lm - ref_lm)
    flat, _ = ravel_pytree(delta)
    return flat


def cam_local_diff(state: WindowState, prior: CamPriorFactor) -> jax.Array:
    """state ⊖ prior linearization over camera blocks, in the
    [dp, dth, dv, dbg, dba] layout of `CamPriorFactor.j`."""
    from ..geometry import so3_log
    dth = jax.vmap(lambda a, b: so3_log(quat_multiply(quat_inverse(b), a)))(
        state.q, prior.q)
    return jnp.concatenate([
        (state.p - prior.p).reshape(-1), dth.reshape(-1),
        (state.v - prior.v).reshape(-1), (state.bg - prior.bg).reshape(-1),
        (state.ba - prior.ba).reshape(-1)])


def _prior_residual(state: WindowState, prior) -> jax.Array:
    if isinstance(prior, CamPriorFactor):
        return prior.j @ cam_local_diff(state, prior) + prior.r0
    dx = local_diff(state, prior.p, prior.q, prior.v, prior.bg, prior.ba,
                    prior.lm)
    return prior.j @ dx + prior.r0


def reprojection_residuals(state: WindowState, meas: WindowMeasurements) -> jax.Array:
    """Whitened, Huber-scaled reprojection residuals, shape (K, L, 2)."""
    # x_cam = R_cb^T? — convention: x_cam = r_cb @ (R_wb^T (lm - p) - p_bc)
    pts_b = jnp.einsum(
        "kij,klj->kli", jax.vmap(lambda q: quat_to_matrix(quat_inverse(q)))(state.q),
        state.lm[None, :, :] - state.p[:, None, :])
    pts_c = jnp.einsum("ij,klj->kli", meas.r_cb, pts_b - meas.p_bc[None, None, :])
    z = pts_c[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    proj = pts_c[..., :2] / safe_z[..., None]
    valid = meas.vis & (z > 0.05) & state.kf_valid[:, None] & state.lm_valid[None, :]
    r = (proj - jnp.nan_to_num(meas.obs)) * meas.pix_weight
    # Huber: scale residual by sqrt(w), w = min(1, delta/||r||)
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    w = jnp.sqrt(jnp.minimum(1.0, meas.huber_delta / jnp.maximum(rn, 1e-9)))
    return jnp.where(valid[..., None], r * w, 0.0)


def _cam_residuals(state: WindowState, meas: WindowMeasurements,
                   anchor_weight: float = 1e3) -> jax.Array:
    """All residuals that do NOT touch landmarks: IMU factors, gauge
    anchors, bias priors, optional linearized prior. Split out so the
    mesh-sharded Schur solver (`parallel.window_schur`) can evaluate the
    replicated camera system separately from the landmark-sharded
    reprojection terms."""
    # IMU factors between consecutive keyframes
    def one(i):
        pre_i = jax.tree_util.tree_map(lambda x: x[i], meas.pre)
        r = imu_residual(pre_i,
                         state.p[i], state.q[i], state.v[i], state.bg[i], state.ba[i],
                         state.p[i + 1], state.q[i + 1], state.v[i + 1],
                         state.bg[i + 1], state.ba[i + 1],
                         weight_bias=meas.bias_weight)
        ok = meas.pre_valid[i] & state.kf_valid[i] & state.kf_valid[i + 1]
        return jnp.where(ok, r, 0.0)

    k = state.p.shape[0]
    r_imu = jax.vmap(one)(jnp.arange(k - 1)).reshape(-1)

    # gauge anchors: position + yaw of the first keyframe are unobservable
    # (pitch/roll are observable from gravity), so pin them to their initial
    # values — the standard VI gauge fixing.
    from ..geometry import wrap_angle, yaw_of
    r_anchor = jnp.concatenate([
        (state.p[0] - meas.anchor_p) * anchor_weight,
        wrap_angle(yaw_of(state.q[0]) - meas.anchor_yaw)[None] * anchor_weight,
    ])

    kf_mask = state.kf_valid.astype(state.p.dtype)[:, None]
    r_bias_prior = jnp.concatenate([
        (state.ba * kf_mask).reshape(-1) * meas.ba_prior_weight,
        (state.bg * kf_mask).reshape(-1) * meas.bg_prior_weight,
    ])
    parts = [r_imu, r_anchor, r_bias_prior]
    if meas.prior is not None:
        parts.append(_prior_residual(state, meas.prior))
    return jnp.concatenate(parts)


def _all_residuals(state: WindowState, meas: WindowMeasurements,
                   anchor_weight: float = 1e3) -> jax.Array:
    r_proj = reprojection_residuals(state, meas).reshape(-1)
    return jnp.concatenate([r_proj,
                            _cam_residuals(state, meas, anchor_weight)])


def solve_window(state: WindowState, meas: WindowMeasurements,
                 iters: int = 8, init_lambda: float = 1e-3,
                 anchor_weight: float = 1e3) -> tuple[WindowState, jax.Array]:
    """Damped Gauss-Newton (LM) with fixed iteration count.

    Mirrors the role of the agent's 8-iteration / 0.04 s solver budget
    (`config/euroc/euroc_config.yaml:54-55`). Returns (state, final cost).
    """
    delta0 = _delta_zero(state)
    flat0, unravel = ravel_pytree(delta0)
    n_params = flat0.shape[0]

    def res_at(st):
        return _all_residuals(st, meas, anchor_weight)

    def lm_step(carry, _):
        st, lam, cost = carry

        def res_of_dx(dx):
            return res_at(retract(st, unravel(dx)))

        r0 = res_of_dx(flat0)
        jmat = jax.jacfwd(res_of_dx)(flat0)  # (R, P)
        h = jmat.T @ jmat
        g = jmat.T @ r0
        diag = jnp.diag(h)
        h_damped = h + jnp.diag(lam * (diag + 1e-6))
        # Jacobi equilibration: float32 Cholesky needs the ~1e6 dynamic range
        # between anchor/pixel and bias blocks squeezed out.
        d = 1.0 / jnp.sqrt(jnp.diag(h_damped) + 1e-12)
        h_eq = h_damped * d[:, None] * d[None, :]
        dx = d * jax.scipy.linalg.solve(h_eq, -(g * d), assume_a="pos")
        st_new = retract(st, unravel(dx))
        cost_new = 0.5 * jnp.sum(res_at(st_new) ** 2)
        accept = cost_new < cost
        # Nielsen's gain-ratio damping: shrink lambda by how well the
        # quadratic model predicted the reduction; grow on rejection.
        pred = -(g @ dx) - 0.5 * (dx @ (h @ dx))
        rho = (cost - cost_new) / jnp.maximum(pred, 1e-12)
        shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        st_out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), st_new, st)
        lam_out = jnp.where(accept, jnp.maximum(lam * shrink, 1e-10),
                            jnp.minimum(lam * 4.0, 1e8))
        cost_out = jnp.where(accept, cost_new, cost)
        return (st_out, lam_out, cost_out), cost_out

    cost0 = 0.5 * jnp.sum(res_at(state) ** 2)
    (state_f, _, cost_f), _ = jax.lax.scan(
        lm_step, (state, jnp.asarray(init_lambda, state.p.dtype), cost0),
        None, length=iters)
    return state_f, cost_f


def solve_window_schur(state: WindowState, meas: WindowMeasurements,
                       iters: int = 8, init_lambda: float = 1e-3,
                       anchor_weight: float = 1e3) -> tuple[WindowState, jax.Array]:
    """LM with Schur-complement landmark elimination.

    The reference's Ceres problem eliminates landmarks implicitly via its
    sparse solver; the classic BA structure is explicit here: every
    reprojection residual touches one landmark, so H_ll is 3×3
    block-diagonal. Per LM step:

      H_red = H_cc − H_cl H_ll⁻¹ H_lc      (reduced camera system, K·15 wide)
      dc    = solve(H_red, −g_red)
      dl_l  = H_ll,l⁻¹ (−g_l − H_cl,lᵀ dc)  (vmapped 3×3 back-substitution)

    The reduced system is what gets all-reduced across hosts in the
    distributed setting (camera states replicated, landmark blocks sharded);
    this single-chip version is the kernel of that plan (BASELINE.json).
    Same contract/semantics as `solve_window`.
    """
    k = state.p.shape[0]
    l = state.lm.shape[0]
    pc = k * 15  # camera-block tangent size (p, th, v, bg, ba)

    def split_res(dc_flat, dl_flat, st):
        """Residuals as a function of (camera tangent, landmark tangent)."""
        dc = dict(dp=dc_flat[0:k * 3].reshape(k, 3),
                  dth=dc_flat[k * 3:k * 6].reshape(k, 3),
                  dv=dc_flat[k * 6:k * 9].reshape(k, 3),
                  dbg=dc_flat[k * 9:k * 12].reshape(k, 3),
                  dba=dc_flat[k * 12:k * 15].reshape(k, 3),
                  dlm=dl_flat.reshape(l, 3))
        return _all_residuals(retract(st, dc), meas, anchor_weight)

    zc = jnp.zeros(pc, state.p.dtype)
    zl = jnp.zeros(l * 3, state.p.dtype)

    def lm_step(carry, _):
        st, lam, cost = carry
        r0 = split_res(zc, zl, st)
        j_c = jax.jacfwd(lambda dc: split_res(dc, zl, st))(zc)   # (R, Pc)
        j_l = jax.jacfwd(lambda dl: split_res(zc, dl, st))(zl)   # (R, 3L)
        j_l3 = j_l.reshape(-1, l, 3)                             # (R, L, 3)

        h_cc = j_c.T @ j_c
        g_c = j_c.T @ r0
        h_ll = jnp.einsum("rla,rlb->lab", j_l3, j_l3)            # (L, 3, 3)
        g_l = jnp.einsum("rla,r->la", j_l3, r0)                  # (L, 3)
        h_cl = jnp.einsum("rc,rla->cla", j_c, j_l3)              # (Pc, L, 3)

        # Marquardt damping on both blocks
        d_cc = jnp.diag(h_cc)
        h_cc_d = h_cc + jnp.diag(lam * (d_cc + 1e-6))
        eye3 = jnp.eye(3, dtype=h_ll.dtype)
        h_ll_d = h_ll + lam * (jax.vmap(jnp.diag)(
            jax.vmap(jnp.diag)(h_ll)) + 1e-6 * eye3)
        # guard unobserved landmarks (zero blocks): make them identity so the
        # inverse is finite; their back-substituted update is 0 anyway
        observed = jnp.einsum("lab->l", jnp.abs(h_ll)) > 1e-12
        h_ll_d = jnp.where(observed[:, None, None], h_ll_d, eye3)
        h_ll_inv = jnp.linalg.inv(h_ll_d)                        # (L, 3, 3)

        # reduced camera system
        w_mat = jnp.einsum("cla,lab->clb", h_cl, h_ll_inv)       # (Pc, L, 3)
        h_red = h_cc_d - jnp.einsum("clb,dlb->cd", w_mat, h_cl)
        g_red = g_c - jnp.einsum("clb,lb->c", w_mat, g_l)
        d = 1.0 / jnp.sqrt(jnp.diag(h_red) + 1e-12)
        dc = d * jax.scipy.linalg.solve(h_red * d[:, None] * d[None, :],
                                        -(g_red * d), assume_a="pos")
        # back-substitute landmarks
        rhs = -g_l - jnp.einsum("cla,c->la", h_cl, dc)           # (L, 3)
        dl = jnp.einsum("lab,lb->la", h_ll_inv, rhs)
        dl = jnp.where(observed[:, None], dl, 0.0)

        st_new = retract(st, dict(
            dp=dc[0:k * 3].reshape(k, 3), dth=dc[k * 3:k * 6].reshape(k, 3),
            dv=dc[k * 6:k * 9].reshape(k, 3), dbg=dc[k * 9:k * 12].reshape(k, 3),
            dba=dc[k * 12:k * 15].reshape(k, 3), dlm=dl))
        cost_new = 0.5 * jnp.sum(split_res(zc, zl, st_new) ** 2)
        accept = cost_new < cost
        # Nielsen gain-ratio damping, predicted reduction from block form
        g_term = g_c @ dc + jnp.einsum("la,la->", g_l, dl)
        q_cc = dc @ (h_cc @ dc)
        q_cl = 2.0 * jnp.einsum("c,cla,la->", dc, h_cl, dl)
        q_ll = jnp.einsum("la,lab,lb->", dl, h_ll, dl)
        pred = -g_term - 0.5 * (q_cc + q_cl + q_ll)
        rho = (cost - cost_new) / jnp.maximum(pred, 1e-12)
        shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        st_out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), st_new, st)
        lam_out = jnp.where(accept, jnp.maximum(lam * shrink, 1e-10),
                            jnp.minimum(lam * 4.0, 1e8))
        return (st_out, lam_out, jnp.where(accept, cost_new, cost)), None

    cost0 = 0.5 * jnp.sum(split_res(zc, zl, state) ** 2)
    (state_f, _, cost_f), _ = jax.lax.scan(
        lm_step, (state, jnp.asarray(init_lambda, state.p.dtype), cost0),
        None, length=iters)
    return state_f, cost_f


def triangulate(p_w: jax.Array, q_w: jax.Array, obs: jax.Array, vis: jax.Array,
                r_cb: jax.Array, p_bc: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Linear multi-view triangulation of one landmark.

    p_w (K,3), q_w (K,4): body poses; obs (K,2) normalized coords; vis (K,).
    Returns (point (3,), ok). DLT over all observing views: for each view,
    rows [u * P_3 - P_1; v * P_3 - P_2] with P = [R_cw | t_cw].
    """
    r_wb = quat_to_matrix(q_w)                      # (K,3,3)
    r_cw = jnp.einsum("ij,kjl->kil", r_cb, r_wb.transpose(0, 2, 1))
    t_cw = -jnp.einsum("kij,kj->ki", r_cw, p_w) - (r_cb @ p_bc)[None]
    # P rows
    p1 = jnp.concatenate([r_cw[:, 0], t_cw[:, 0:1]], axis=1)  # (K,4)
    p2 = jnp.concatenate([r_cw[:, 1], t_cw[:, 1:2]], axis=1)
    p3 = jnp.concatenate([r_cw[:, 2], t_cw[:, 2:3]], axis=1)
    u, v = obs[:, 0], obs[:, 1]
    rows = jnp.concatenate([
        (u[:, None] * p3 - p1) * vis[:, None],
        (v[:, None] * p3 - p2) * vis[:, None],
    ], axis=0)  # (2K, 4)
    ata = rows.T @ rows
    w, vecs = jnp.linalg.eigh(ata)
    x = vecs[:, 0]
    ok = (jnp.abs(x[3]) > 1e-9) & (jnp.sum(vis) >= 2)
    pt = x[:3] / jnp.where(jnp.abs(x[3]) > 1e-9, x[3], 1e-9)
    return pt, ok


def landmark_quality(p_w: jax.Array, q_w: jax.Array, kf_valid: jax.Array,
                     obs: jax.Array, vis: jax.Array, lm: jax.Array,
                     r_cb: jax.Array, p_bc: jax.Array):
    """Per-landmark geometric quality over the window (batched).

    p_w (K,3), q_w (K,4), kf_valid (K,), obs (K,L,2), vis (K,L), lm (L,3).
    Returns (min_depth (L,), max_res (L,), parallax (L,)):
      min_depth — smallest z over observing cameras (+inf if none): the
        cheirality gate a bare DLT lacks;
      max_res   — worst reprojection residual (normalized coords) over
        observing views;
      parallax  — largest angle (rad) between the rays from any two observing
        cameras to the point: near-zero means the depth is unobservable (the
        class of landmark that "triangulates" to +-1000s of meters with tiny
        residual and then poisons PnP with garbage 3-D).
    """
    r_wb = quat_to_matrix(q_w)                              # (K,3,3)
    diff = lm[None, :, :] - p_w[:, None, :]                 # (K,L,3)
    pts_b = jnp.einsum("kji,klj->kli", r_wb, diff)
    pts_c = jnp.einsum("ij,klj->kli", r_cb, pts_b - p_bc[None, None, :])
    z = pts_c[..., 2]
    see = vis & kf_valid[:, None]
    min_depth = jnp.min(jnp.where(see, z, jnp.inf), axis=0)
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    proj = pts_c[..., :2] / safe_z[..., None]
    res = jnp.linalg.norm(proj - jnp.nan_to_num(obs), axis=-1)
    max_res = jnp.max(jnp.where(see, res, 0.0), axis=0)
    # rays world-frame from camera centers to the landmark
    centers = p_w + jnp.einsum("kij,j->ki", r_wb, p_bc)     # (K,3)
    rays = lm[None, :, :] - centers[:, None, :]             # (K,L,3)
    rays = rays / jnp.maximum(jnp.linalg.norm(rays, axis=-1, keepdims=True),
                              1e-9)
    cosang = jnp.einsum("kli,mli->kml", rays, rays)         # (K,K,L)
    pair_ok = see[:, None, :] & see[None, :, :]
    parallax = jnp.arccos(jnp.clip(
        jnp.min(jnp.where(pair_ok, cosang, 1.0), axis=(0, 1)), -1.0, 1.0))
    return min_depth, max_res, parallax


def _marg_residuals(state: WindowState, meas: WindowMeasurements) -> jax.Array:
    """Residuals of ONLY the factors connected to the leaving keyframe
    (slot 0), plus the previous linearized prior — the factor subset a
    fixed-lag marginalization is allowed to absorb.

    Marginalizing over `_all_residuals` instead DOUBLE-COUNTS every factor
    among the surviving states (their information lands in the prior AND
    stays live in the window), compounding ~2-3x per shift — measured as the
    round-3/4 post-marginalization cost blowup (64 -> 9000 over four shifts)
    with acc-bias estimates dragged to ~0.1 m/s². The gauge anchor is also
    excluded: the prior must keep the gauge null-space (each solve re-anchors
    the current first keyframe; folding the old anchor in pins absolute pose
    twice). This is the VINS marginalization factor set (slot-0 reprojection
    + the slot-0/1 preintegration factor + last prior)."""
    k = state.p.shape[0]
    vis0 = meas.vis & (jnp.arange(k)[:, None] == 0)
    r_proj = reprojection_residuals(state, meas._replace(vis=vis0)).reshape(-1)

    pre0 = jax.tree_util.tree_map(lambda x: x[0], meas.pre)
    r_imu = imu_residual(pre0, state.p[0], state.q[0], state.v[0],
                         state.bg[0], state.ba[0], state.p[1], state.q[1],
                         state.v[1], state.bg[1], state.ba[1],
                         weight_bias=meas.bias_weight)
    ok = meas.pre_valid[0] & state.kf_valid[0] & state.kf_valid[1]
    r_imu = jnp.where(ok, r_imu, 0.0)

    w0 = state.kf_valid[0].astype(state.p.dtype)
    r_bp = jnp.concatenate([state.ba[0] * (meas.ba_prior_weight * w0),
                            state.bg[0] * (meas.bg_prior_weight * w0)])
    parts = [r_proj, r_imu, r_bp]
    if meas.prior is not None:
        parts.append(_prior_residual(state, meas.prior))
    return jnp.concatenate(parts)


def marginalize_prior(state: WindowState, meas: WindowMeasurements,
                      marg_mask_flat: jax.Array,
                      anchor_weight: float = 1e3,
                      eig_floor: float = 1e-8) -> tuple[jax.Array, jax.Array]:
    """Schur-marginalize a subset of tangent variables, returning a dense
    sqrt-information prior (j, r0) over the FULL tangent layout (marginalized
    columns are zero). The caller pairs this with the current state as the
    linearization point.

    Built from `_marg_residuals` — the slot-0-connected factor subset plus
    the previous prior — NOT the full window residual set (see the
    double-counting note there). marg_mask_flat: (P,) bool over the flat
    tangent (True = marginalize). Fixed-shape formulation: instead of
    slicing variable-size blocks, the kept block is
    H_kk - H_km H_mm^{-1} H_mk computed with masked matrices.
    """
    delta0 = _delta_zero(state)
    flat0, unravel = ravel_pytree(delta0)

    def res_of_dx(dx):
        return _marg_residuals(retract(state, unravel(dx)), meas)

    r0 = res_of_dx(flat0)
    jmat = jax.jacfwd(res_of_dx)(flat0)
    h = jmat.T @ jmat
    g = jmat.T @ r0
    m = marg_mask_flat
    keep = ~m
    # masked Schur: H_mm restricted (identity on kept rows to stay invertible).
    # The marginalized block itself also gets a small Tikhonov diagonal: a
    # dying landmark can leave with a SINGLE observation (2 residual rows for
    # 3 unknowns -> rank-deficient block), and an exactly singular H_mm turns
    # the whole prior into NaNs (the round-3 post-bootstrap NaN solves)
    h_mm = jnp.where(m[:, None] & m[None, :], h, jnp.eye(h.shape[0], dtype=h.dtype))
    mm_scale = jnp.maximum(jnp.max(jnp.abs(jnp.diag(h_mm))), 1.0)
    h_mm = h_mm + (1e-7 * mm_scale) * jnp.diag(m.astype(h.dtype))
    h_km = jnp.where(keep[:, None] & m[None, :], h, 0.0)
    h_kk = jnp.where(keep[:, None] & keep[None, :], h, 0.0)
    g_m = jnp.where(m, g, 0.0)
    g_k = jnp.where(keep, g, 0.0)
    sol = jnp.linalg.solve(h_mm, jnp.concatenate([h_km.T, g_m[:, None]], axis=1))
    h_new = h_kk - h_km @ sol[:, :-1]
    g_new = g_k - h_km @ sol[:, -1]
    # sqrt factorization with eigenvalue flooring
    w, v = jnp.linalg.eigh(0.5 * (h_new + h_new.T))
    w_c = jnp.maximum(w, 0.0)
    sqrt_w = jnp.sqrt(w_c)
    j_prior = (v * sqrt_w[None, :]) @ v.T
    # r0 such that J dx + r0 reproduces gradient: r0 = J^{-+} g_new
    inv_sqrt = jnp.where(sqrt_w > eig_floor, 1.0 / jnp.maximum(sqrt_w, eig_floor), 0.0)
    r0_prior = (v * inv_sqrt[None, :]) @ (v.T @ g_new)
    return j_prior, r0_prior


# ---------------------------------------------------------------------------
# Camera-only marginalization + structure-exploiting Schur solve — the
# front-end's production path (round 5).
# ---------------------------------------------------------------------------

def retract_cam(state: WindowState, dc: jax.Array) -> WindowState:
    """Apply a camera-block tangent in the [dp, dth, dv, dbg, dba] layout
    (landmarks untouched) — the Schur/`CamPriorFactor` layout."""
    k = state.p.shape[0]
    return retract(state, dict(
        dp=dc[0:k * 3].reshape(k, 3), dth=dc[k * 3:k * 6].reshape(k, 3),
        dv=dc[k * 6:k * 9].reshape(k, 3), dbg=dc[k * 9:k * 12].reshape(k, 3),
        dba=dc[k * 12:k * 15].reshape(k, 3),
        dlm=jnp.zeros_like(state.lm)))


def _slot0_residuals(state: WindowState, meas: WindowMeasurements,
                     dying: jax.Array) -> jax.Array:
    """Residuals of the VINS marginalization factor set, computed compactly:
    slot-0 reprojections of DYING landmarks only (2L rows — observations of
    SURVIVING landmarks from the leaving frame are dropped, exactly as VINS
    drops them so the prior stays camera-only), the slot-0/1 preintegration
    factor, the slot-0 bias prior, and the previous (camera-only) prior."""
    r_bw0 = quat_to_matrix(quat_inverse(state.q[0]))
    pts_b = jnp.einsum("ij,lj->li", r_bw0, state.lm - state.p[0][None])
    pts_c = jnp.einsum("ij,lj->li", meas.r_cb, pts_b - meas.p_bc[None])
    z = pts_c[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    proj = pts_c[:, :2] / safe_z[:, None]
    valid = (meas.vis[0] & dying & (z > 0.05) & state.kf_valid[0]
             & state.lm_valid)
    r = (proj - jnp.nan_to_num(meas.obs[0])) * meas.pix_weight
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    w = jnp.sqrt(jnp.minimum(1.0, meas.huber_delta / jnp.maximum(rn, 1e-9)))
    r_proj = jnp.where(valid[:, None], r * w, 0.0).reshape(-1)

    pre0 = jax.tree_util.tree_map(lambda x: x[0], meas.pre)
    r_imu = imu_residual(pre0, state.p[0], state.q[0], state.v[0],
                         state.bg[0], state.ba[0], state.p[1], state.q[1],
                         state.v[1], state.bg[1], state.ba[1],
                         weight_bias=meas.bias_weight)
    ok = meas.pre_valid[0] & state.kf_valid[0] & state.kf_valid[1]
    r_imu = jnp.where(ok, r_imu, 0.0)

    w0 = state.kf_valid[0].astype(state.p.dtype)
    r_bp = jnp.concatenate([state.ba[0] * (meas.ba_prior_weight * w0),
                            state.bg[0] * (meas.bg_prior_weight * w0)])
    parts = [r_proj, r_imu, r_bp]
    if meas.prior is not None:
        parts.append(_prior_residual(state, meas.prior))
    return jnp.concatenate(parts)


from functools import partial as _partial  # noqa: E402


@_partial(jax.jit, donate_argnums=())
def marginalize_prior_cam(state: WindowState, meas: WindowMeasurements,
                          dying: jax.Array,
                          eig_floor: float = 1e-8
                          ) -> tuple[jax.Array, jax.Array]:
    """Schur-marginalize slot 0 (and the landmarks dying with it) into a
    CAMERA-ONLY sqrt-information prior (j (15K, 15K), r0) over the
    [dp, dth, dv, dbg, dba] layout at the CURRENT window indexing (the
    caller shifts columns when it rolls the window).

    This is VINS's marginalization design (`marginalization_factor.cpp`):
    the prior never carries landmark columns, so the window solve's H_ll
    stays block-diagonal and Schur landmark elimination stays exact — and
    the prior itself is 15K wide instead of 15K+3L (the full-tangent
    variant cost seconds per keyframe at L=600 on a CPU host and broke the
    Schur solver's exactness)."""
    k = state.p.shape[0]
    l = state.lm.shape[0]
    pc = 15 * k

    def res_of(dcl):
        st = retract_cam(state, dcl[:pc])
        st = st._replace(lm=st.lm + dcl[pc:].reshape(l, 3))
        return _slot0_residuals(st, meas, dying)

    z = jnp.zeros(pc + 3 * l, state.p.dtype)
    r0 = res_of(z)
    jmat = jax.jacfwd(res_of)(z)
    h = jmat.T @ jmat
    g = jmat.T @ r0
    # marginalize: slot-0 columns of every camera block + ALL landmark
    # columns (dying ones carry the folded factors; surviving ones have zero
    # information here, so eliminating them is a no-op)
    m = jnp.zeros(pc + 3 * l, bool)
    for b in range(5):
        m = m.at[b * 3 * k:b * 3 * k + 3].set(True)
    m = m.at[pc:].set(True)
    keep = ~m
    h_mm = jnp.where(m[:, None] & m[None, :], h,
                     jnp.eye(h.shape[0], dtype=h.dtype))
    mm_scale = jnp.maximum(jnp.max(jnp.abs(jnp.diag(h_mm))), 1.0)
    h_mm = h_mm + (1e-7 * mm_scale) * jnp.diag(m.astype(h.dtype))
    h_km = jnp.where(keep[:, None] & m[None, :], h, 0.0)
    h_kk = jnp.where(keep[:, None] & keep[None, :], h, 0.0)
    g_m = jnp.where(m, g, 0.0)
    g_k = jnp.where(keep, g, 0.0)
    sol = jnp.linalg.solve(h_mm, jnp.concatenate([h_km.T, g_m[:, None]], 1))
    h_new = h_kk - h_km @ sol[:, :-1]
    g_new = g_k - h_km @ sol[:, -1]
    # compress to the camera block (landmark rows/cols are zero by
    # construction) before the eigendecomposition: eigh(15K) not eigh(15K+3L)
    h_cam = h_new[:pc, :pc]
    g_cam = g_new[:pc]
    w, v = jnp.linalg.eigh(0.5 * (h_cam + h_cam.T))
    w_c = jnp.maximum(w, 0.0)
    sqrt_w = jnp.sqrt(w_c)
    j_prior = (v * sqrt_w[None, :]) @ v.T
    inv_sqrt = jnp.where(sqrt_w > eig_floor,
                         1.0 / jnp.maximum(sqrt_w, eig_floor), 0.0)
    r0_prior = (v * inv_sqrt[None, :]) @ (v.T @ g_cam)
    return j_prior, r0_prior


def _proj_residual_one_lm(p, q, kf_valid, lm_valid_one, r_cb, p_bc,
                          pix_weight, huber_delta, lm_pt, obs, vis):
    """Whitened Huber reprojection residual (2K,) of ONE landmark against
    all window keyframes — matches `reprojection_residuals` semantics."""
    r_bw = jax.vmap(lambda qq: quat_to_matrix(quat_inverse(qq)))(q)
    pts_b = jnp.einsum("kij,kj->ki", r_bw, lm_pt[None] - p)
    pts_c = jnp.einsum("ij,kj->ki", r_cb, pts_b - p_bc[None])
    z = pts_c[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    proj = pts_c[:, :2] / safe_z[:, None]
    valid = vis & (z > 0.05) & kf_valid & lm_valid_one
    r = (proj - jnp.nan_to_num(obs)) * pix_weight
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    w = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-9)))
    return jnp.where(valid[:, None], r * w, 0.0).reshape(-1)


def solve_window_fast(state: WindowState, meas: WindowMeasurements,
                      iters: int = 8, init_lambda: float = 1e-3,
                      anchor_weight: float = 1e3
                      ) -> tuple[WindowState, jax.Array]:
    """LM with exact Schur landmark elimination, assembled per landmark.

    Same semantics as `solve_window_schur`, but the reprojection Jacobians
    are built per landmark (vmapped (2K, 15K+3) blocks) instead of one dense
    (R, 15K+3L) jacfwd — the cost drops from O(R·(15K+3L)) to O(L·K·15K),
    ~10x on the agent config. This is the single-device form of
    `parallel.window_schur.solve_window_schur_sharded`'s per-device body,
    plus camera-only prior support (`CamPriorFactor`; a full-tangent
    `PriorFactor` would break H_ll block-diagonality and is rejected).

    The front-end's per-keyframe solve (the reference agent's 8-iteration /
    0.04 s solver budget, `euroc_config.yaml:54-55`) runs THIS path.
    """
    if meas.prior is not None and not isinstance(meas.prior, CamPriorFactor):
        raise ValueError("solve_window_fast needs a camera-only prior "
                         "(CamPriorFactor) — full-tangent priors couple "
                         "landmarks and break the Schur structure")
    return _solve_window_fast_jit(state, meas, iters,
                                  float(init_lambda), float(anchor_weight))


@_partial(jax.jit, static_argnames=("iters",))
def _solve_window_fast_jit(state: WindowState, meas: WindowMeasurements,
                           iters: int, init_lambda: float,
                           anchor_weight: float):
    k = state.p.shape[0]
    l = state.lm.shape[0]
    pc = 15 * k
    obs_lk = jnp.moveaxis(jnp.nan_to_num(meas.obs), 1, 0)   # (L, K, 2)
    vis_lk = jnp.moveaxis(meas.vis, 1, 0)                    # (L, K)
    pixw = meas.pix_weight
    hub = meas.huber_delta
    eye3 = jnp.eye(3, dtype=state.p.dtype)
    zc = jnp.zeros(pc, state.p.dtype)

    def cam_res(st):
        return _cam_residuals(st, meas, anchor_weight)

    def proj_cost(st):
        r = jax.vmap(lambda lm_pt, lmv, o, vi: _proj_residual_one_lm(
            st.p, st.q, st.kf_valid, lmv, meas.r_cb, meas.p_bc, pixw, hub,
            lm_pt, o, vi))(st.lm, st.lm_valid, obs_lk, vis_lk)
        return 0.5 * jnp.sum(r ** 2)

    def total_cost(st):
        return 0.5 * jnp.sum(cam_res(st) ** 2) + proj_cost(st)

    def lm_step(carry, _):
        st, lam, cost = carry

        def cam_res_dc(dc):
            return cam_res(retract_cam(st, dc))
        r_cam = cam_res_dc(zc)
        j_cam = jax.jacfwd(cam_res_dc)(zc)
        h_cc_cam = j_cam.T @ j_cam
        g_c_cam = j_cam.T @ r_cam

        def one_lm(lm_pt, lmv, o, vi):
            def res(dcl):
                st2 = retract_cam(st, dcl[:pc])
                return _proj_residual_one_lm(
                    st2.p, st2.q, st.kf_valid, lmv, meas.r_cb, meas.p_bc,
                    pixw, hub, lm_pt + dcl[pc:], o, vi)
            zz = jnp.zeros(pc + 3, state.p.dtype)
            return res(zz), jax.jacfwd(res)(zz)

        r0s, jmats = jax.vmap(one_lm)(st.lm, st.lm_valid, obs_lk, vis_lk)
        jcs, jls = jmats[:, :, :pc], jmats[:, :, pc:]
        h_ll = jnp.einsum("lra,lrb->lab", jls, jls)
        g_l = jnp.einsum("lra,lr->la", jls, r0s)
        h_cl = jnp.einsum("lrc,lra->lca", jcs, jls)
        h_cc = h_cc_cam + jnp.einsum("lrc,lrd->cd", jcs, jcs)
        g_c = g_c_cam + jnp.einsum("lrc,lr->c", jcs, r0s)
        cost_chk = 0.5 * (jnp.sum(r0s ** 2) + jnp.sum(r_cam ** 2))

        h_ll_d = h_ll + lam * (jax.vmap(jnp.diag)(
            jax.vmap(jnp.diag)(h_ll)) + 1e-6 * eye3)
        observed = jnp.einsum("lab->l", jnp.abs(h_ll)) > 1e-12
        h_ll_d = jnp.where(observed[:, None, None], h_ll_d, eye3)
        h_ll_inv = jnp.linalg.inv(h_ll_d)
        w_mat = jnp.einsum("lca,lab->lcb", h_cl, h_ll_inv)
        d_cc = jnp.diag(h_cc)
        h_red = (h_cc + jnp.diag(lam * (d_cc + 1e-6))
                 - jnp.einsum("lcb,ldb->cd", w_mat, h_cl))
        g_red = g_c - jnp.einsum("lcb,lb->c", w_mat, g_l)
        d = 1.0 / jnp.sqrt(jnp.diag(h_red) + 1e-12)
        dc = d * jax.scipy.linalg.solve(h_red * d[:, None] * d[None, :],
                                        -(g_red * d), assume_a="pos")
        rhs = -g_l - jnp.einsum("lca,c->la", h_cl, dc)
        dl = jnp.einsum("lab,lb->la", h_ll_inv, rhs)
        dl = jnp.where(observed[:, None], dl, 0.0)

        st_new = retract_cam(st, dc)._replace(lm=st.lm + dl)
        cost_new = total_cost(st_new)
        accept = cost_new < cost
        g_term = g_c @ dc + jnp.einsum("la,la->", g_l, dl)
        q_cc = dc @ (h_cc @ dc)
        q_cl = 2.0 * jnp.einsum("c,lca,la->", dc, h_cl, dl)
        q_ll = jnp.einsum("la,lab,lb->", dl, h_ll, dl)
        pred = -g_term - 0.5 * (q_cc + q_cl + q_ll)
        rho = (cost - cost_new) / jnp.maximum(pred, 1e-12)
        shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        st_out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), st_new, st)
        lam_out = jnp.where(accept, jnp.maximum(lam * shrink, 1e-10),
                            jnp.minimum(lam * 4.0, 1e8))
        _ = cost_chk
        return (st_out, lam_out, jnp.where(accept, cost_new, cost)), None

    cost0 = total_cost(state)
    (state_f, _, cost_f), _ = jax.lax.scan(
        lm_step, (state, jnp.asarray(init_lambda, state.p.dtype), cost0),
        None, length=iters)
    return state_f, cost_f
