"""Mesh-sharded Schur-complement sliding-window VI bundle adjustment.

The distributed form of `vio.window_ba.solve_window_schur` — the multi-host
BA called for by BASELINE.json (camera system replicated, landmarks sharded):

- the landmark axis is sharded across the device mesh (`shard_map`); each
  device builds its landmarks' reprojection residuals, 3×3 Hessian blocks
  and their Schur contribution to the reduced camera system locally;
- ONE `psum` per LM iteration all-reduces the packed reduced system
  (≈ 2·(15K)² + 2·15K + 1 floats for a K-keyframe window — independent of
  landmark count, which is what keeps scaling efficiency high over NVLink or the network);
- the small (15K)-wide damped solve and the accept/reject logic run
  replicated; landmark back-substitution is local.

Plays the role of the reference's Ceres sparse solve
(`/root/reference/server_pose_graph/src/server_pose_graph.cpp:1706`) scaled
past one host; semantics match `solve_window_schur` (equivalence-tested on
an 8-virtual-device CPU mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry import quat_inverse, quat_to_matrix
from ..vio import window_ba as ba
from ..vio.window_ba import WindowMeasurements, WindowState

__all__ = ["solve_window_schur_sharded"]


def _retract_cam(state: WindowState, dc: jax.Array, k: int) -> WindowState:
    """Apply a camera-block tangent (layout matches `solve_window_schur`)."""
    z_lm = jnp.zeros_like(state.lm)
    return ba.retract(state, dict(
        dp=dc[0:k * 3].reshape(k, 3), dth=dc[k * 3:k * 6].reshape(k, 3),
        dv=dc[k * 6:k * 9].reshape(k, 3), dbg=dc[k * 9:k * 12].reshape(k, 3),
        dba=dc[k * 12:k * 15].reshape(k, 3), dlm=z_lm))


def _proj_residual_one(p, q, kf_valid, r_cb, p_bc, pix_weight, huber_delta,
                       lm_pt, obs, vis):
    """Whitened Huber reprojection residual (2K,) of ONE landmark against all
    window keyframes — the per-landmark unit the mesh shards over. Matches
    `window_ba.reprojection_residuals` semantics exactly."""
    r_bw = jax.vmap(lambda qq: quat_to_matrix(quat_inverse(qq)))(q)
    pts_b = jnp.einsum("kij,kj->ki", r_bw, lm_pt[None] - p)
    pts_c = jnp.einsum("ij,kj->ki", r_cb, pts_b - p_bc[None])
    z = pts_c[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    proj = pts_c[:, :2] / safe_z[:, None]
    valid = vis & (z > 0.05) & kf_valid
    r = (proj - jnp.nan_to_num(obs)) * pix_weight
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    w = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-9)))
    return jnp.where(valid[:, None], r * w, 0.0).reshape(-1)


def solve_window_schur_sharded(mesh: Mesh, state: WindowState,
                               meas: WindowMeasurements, iters: int = 8,
                               init_lambda: float = 1e-3,
                               anchor_weight: float = 1e3,
                               audit_label: str | None = None
                               ) -> tuple[WindowState, jax.Array]:
    """LM with Schur landmark elimination, landmarks sharded over `mesh`.

    Same contract as `vio.window_ba.solve_window_schur` (prior unsupported:
    a dense prior couples all landmarks and belongs on the replicated path).
    Pads the landmark axis to a mesh multiple; returns state in the original
    capacity.

    `audit_label`: when set, the compiled HLO's cross-device collectives are
    summarized (payload per instruction) and printed under this label —
    the production-shape collective audit (VERDICT r4 item 4).
    """
    if meas.prior is not None:
        raise ValueError("sharded Schur solve does not support a dense prior")
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    k = state.p.shape[0]
    l = state.lm.shape[0]
    pc = k * 15
    pad = (-l) % n_dev

    lm_p = jnp.pad(state.lm, ((0, pad), (0, 0)))
    lmv_p = jnp.pad(state.lm_valid, (0, pad))
    obs_lk = jnp.pad(jnp.moveaxis(jnp.nan_to_num(meas.obs), 1, 0),
                     ((0, pad), (0, 0), (0, 0)))          # (L', K, 2)
    vis_lk = jnp.pad(jnp.moveaxis(meas.vis, 1, 0), ((0, pad), (0, 0)))

    pixw = float(meas.pix_weight)
    hub = float(meas.huber_delta)

    def body(p, q, v, bg, ba_, kf_valid, lm_loc, lmv_loc, obs_loc, vis_loc,
             pre, pre_valid, r_cb, p_bc, anchor_p, anchor_yaw):
        st0 = WindowState(p=p, q=q, v=v, bg=bg, ba=ba_, lm=lm_loc,
                          kf_valid=kf_valid, lm_valid=lmv_loc)
        meas_cam = WindowMeasurements(
            obs=jnp.zeros((k, 1, 2), p.dtype), vis=jnp.zeros((k, 1), bool),
            pre=pre, pre_valid=pre_valid, r_cb=r_cb, p_bc=p_bc,
            pix_weight=pixw, huber_delta=hub, bias_weight=meas.bias_weight,
            prior=None, anchor_p=anchor_p, anchor_yaw=anchor_yaw,
            ba_prior_weight=meas.ba_prior_weight,
            bg_prior_weight=meas.bg_prior_weight)
        zc = jnp.zeros(pc, p.dtype)
        eye3 = jnp.eye(3, dtype=p.dtype)

        def proj_cost_local(st):
            r = jax.vmap(lambda lm_pt, lmv, o, vi: _proj_residual_one(
                st.p, st.q, kf_valid, r_cb, p_bc, pixw, hub,
                lm_pt, o, vi & lmv))(st.lm, lmv_loc, obs_loc, vis_loc)
            return 0.5 * jnp.sum(r ** 2)

        def total_cost(st):
            c_cam = 0.5 * jnp.sum(
                ba._cam_residuals(st, meas_cam, anchor_weight) ** 2)
            return c_cam + lax.psum(proj_cost_local(st), axis)

        def lm_step(carry, _):
            st, lam, cost = carry

            # replicated camera-only system
            def cam_res(dc):
                return ba._cam_residuals(_retract_cam(st, dc, k), meas_cam,
                                         anchor_weight)
            r_cam = cam_res(zc)
            j_cam = jax.jacfwd(cam_res)(zc)
            h_cc_cam = j_cam.T @ j_cam
            g_c_cam = j_cam.T @ r_cam
            cost_cam = 0.5 * jnp.sum(r_cam ** 2)

            # local per-landmark blocks
            def one_lm(lm_pt, lmv, o, vi):
                def res(dcl):
                    st2 = _retract_cam(st, dcl[:pc], k)
                    return _proj_residual_one(
                        st2.p, st2.q, kf_valid, r_cb, p_bc, pixw, hub,
                        lm_pt + dcl[pc:], o, vi & lmv)
                zz = jnp.zeros(pc + 3, p.dtype)
                return res(zz), jax.jacfwd(res)(zz)

            r0s, jmats = jax.vmap(one_lm)(st.lm, lmv_loc, obs_loc, vis_loc)
            jcs, jls = jmats[:, :, :pc], jmats[:, :, pc:]   # (Ll,2K,Pc),(Ll,2K,3)
            h_ll = jnp.einsum("lra,lrb->lab", jls, jls)
            g_l = jnp.einsum("lra,lr->la", jls, r0s)
            h_cl = jnp.einsum("lrc,lra->lca", jcs, jls)     # (Ll, Pc, 3)
            h_cc_loc = jnp.einsum("lrc,lrd->cd", jcs, jcs)
            g_c_loc = jnp.einsum("lrc,lr->c", jcs, r0s)
            cost_proj_loc = 0.5 * jnp.sum(r0s ** 2)

            # damp + invert landmark blocks locally (lam is replicated)
            h_ll_d = h_ll + lam * (jax.vmap(jnp.diag)(
                jax.vmap(jnp.diag)(h_ll)) + 1e-6 * eye3)
            observed = jnp.einsum("lab->l", jnp.abs(h_ll)) > 1e-12
            h_ll_d = jnp.where(observed[:, None, None], h_ll_d, eye3)
            h_ll_inv = jnp.linalg.inv(h_ll_d)
            w_mat = jnp.einsum("lca,lab->lcb", h_cl, h_ll_inv)
            schur_loc = jnp.einsum("lcb,ldb->cd", w_mat, h_cl)
            wg_loc = jnp.einsum("lcb,lb->c", w_mat, g_l)

            # ONE all-reduce: pack the reduced-system pieces + scalar cost
            packed = jnp.concatenate([
                h_cc_loc.reshape(-1), schur_loc.reshape(-1),
                g_c_loc, wg_loc, cost_proj_loc[None]])
            packed = lax.psum(packed, axis)
            h_cc_sum = packed[:pc * pc].reshape(pc, pc)
            schur = packed[pc * pc:2 * pc * pc].reshape(pc, pc)
            g_c_sum = packed[2 * pc * pc:2 * pc * pc + pc]
            wg = packed[2 * pc * pc + pc:2 * pc * pc + 2 * pc]
            cost_proj = packed[-1]

            h_cc = h_cc_cam + h_cc_sum
            d_cc = jnp.diag(h_cc)
            h_red = h_cc + jnp.diag(lam * (d_cc + 1e-6)) - schur
            g_red = (g_c_cam + g_c_sum) - wg
            d = 1.0 / jnp.sqrt(jnp.diag(h_red) + 1e-12)
            dc = d * jax.scipy.linalg.solve(h_red * d[:, None] * d[None, :],
                                            -(g_red * d), assume_a="pos")

            # local landmark back-substitution
            rhs = -g_l - jnp.einsum("lca,c->la", h_cl, dc)
            dl = jnp.einsum("lab,lb->la", h_ll_inv, rhs)
            dl = jnp.where(observed[:, None], dl, 0.0)

            st_new = _retract_cam(st, dc, k)._replace(lm=st.lm + dl)
            cost_new = total_cost(st_new)
            accept = cost_new < cost

            # Nielsen gain-ratio damping; landmark terms reduced in one psum
            q_cl_loc = 2.0 * jnp.einsum("c,lca,la->", dc, h_cl, dl)
            q_ll_loc = jnp.einsum("la,lab,lb->", dl, h_ll, dl)
            g_l_loc = jnp.einsum("la,la->", g_l, dl)
            lterms = lax.psum(jnp.stack([q_cl_loc, q_ll_loc, g_l_loc]), axis)
            g_term = (g_c_cam + g_c_sum) @ dc + lterms[2]
            pred = -g_term - 0.5 * (dc @ (h_cc @ dc) + lterms[0] + lterms[1])
            rho = (cost - cost_new) / jnp.maximum(pred, 1e-12)
            shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            st_out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), st_new, st)
            lam_out = jnp.where(accept, jnp.maximum(lam * shrink, 1e-10),
                                jnp.minimum(lam * 4.0, 1e8))
            _ = cost_cam  # cost carried via total_cost; kept for clarity
            return (st_out, lam_out, jnp.where(accept, cost_new, cost)), None

        cost0 = total_cost(st0)
        (st_f, _, cost_f), _ = lax.scan(
            lm_step, (st0, jnp.asarray(init_lambda, p.dtype), cost0),
            None, length=iters)
        return (st_f.p, st_f.q, st_f.v, st_f.bg, st_f.ba,
                st_f.lm, cost_f)

    repl = P()
    shd = P(axis)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(repl, repl, repl, repl, repl, repl,   # camera state
                  shd, shd, shd, shd,                   # landmark-major
                  repl, repl, repl, repl, repl, repl),  # pre + extrinsics
        out_specs=(repl, repl, repl, repl, repl, shd, repl),
        check_vma=False)
    args = (state.p, state.q, state.v, state.bg, state.ba, state.kf_valid,
            lm_p, lmv_p, obs_lk, vis_lk, meas.pre, meas.pre_valid,
            meas.r_cb, meas.p_bc, meas.anchor_p,
            jnp.asarray(meas.anchor_yaw, state.p.dtype))
    jitted = jax.jit(fn)
    if audit_label is not None:
        from .audit import summarize_collectives
        compiled = jitted.lower(*args).compile()
        print(f"  {summarize_collectives(compiled, audit_label)}",
              flush=True)
        p, q, v, bg, ba_, lm_out, cost = compiled(*args)
    else:
        p, q, v, bg, ba_, lm_out, cost = jitted(*args)
    out = state._replace(p=p, q=q, v=v, bg=bg, ba=ba_, lm=lm_out[:l])
    return out, cost
