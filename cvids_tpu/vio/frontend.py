"""Per-agent VIO front-end: pixels + IMU in, keyframe packets out.

This is Layer A of SURVEY.md — external to the reference repo (a VINS-Mono
class estimator, contract defined by `agent_msg/msg/AgentMsg.msg` + the
`config/euroc/*.yaml` feature-tracker/solver keys) — built here as batched array programs:

- feature maintenance: pyramidal KLT tracking + grid-spread FAST
  re-detection, all batched (`ops.klt`, `ops.fast`);
- state estimation: fixed-lag sliding-window visual-inertial LM over the
  window (`vio.window_ba`), IMU preintegration between keyframes;
- output: `KeyframePacket` ≈ AgentMsg — pose, window landmarks (3D + 2D +
  ids + BRIEF), extra full-image features for server-side loop closure.

Fixed capacities everywhere: the window slides by rolling arrays host-side;
the solver itself is one jitted call per keyframe.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import make_camera
from ..geometry import g2r, matrix_to_quat, quat_to_matrix
from ..geometry.hostmath import quat_to_matrix_np
from ..io.msgs import KeyframePacket
from ..ops import brief, fast, klt
from ..utils.config import AgentConfig
from ..utils.precision import full_precision
from . import imu as imu_mod
from . import window_ba as ba

__all__ = ["AgentFrontend"]


class AgentFrontend:
    MAX_IMU = 256       # IMU samples per keyframe interval (1.28 s @ 200 Hz)
    LM_MULT = 4         # landmark-slot pool = LM_MULT x max_features

    def __init__(self, cfg: AgentConfig, client_id: int = 0):
        self.cfg = cfg
        self.client_id = client_id
        # sliding-window length: the VINS operating point is 10
        # (`euroc_config.yaml` window_size; raised from 8 per VERDICT r4
        # item 2 — the longer window keeps ~25 % more parallax per solve)
        self.WINDOW = int(getattr(cfg, "window_size", 10) or 10)
        # polymorphic camera (pinhole / equidistant fisheye / Mei) — the
        # camodocal `Camera` role in the live pipeline
        # (`camera_models/Camera.h:72-90`); the front-end only touches the
        # lift/project interface + an effective focal for pixel weights
        self.cam = make_camera(cfg.camera)
        self.r_cb = np.asarray(cfg.r_cb, np.float32)
        self.p_bc = np.asarray(cfg.p_bc, np.float32)

        # tracked-feature capacity = `max_cnt` (euroc_config.yaml:44);
        # landmark slots are a separate, larger pool: features churn as they
        # leave the FOV but their landmarks stay observable by the rest of
        # the window. Under fast rotation the churn reaches ~0.3x max_cnt
        # fresh features per keyframe, so an 8-frame window needs ~
        # (1 + 0.3 * 8) x max_cnt slots; 4x covers it (2x measured as slot
        # exhaustion -> new features silently dropped -> loop PnP starved)
        self.MAX_FEAT = mf = int(cfg.max_features)
        self.MAX_LM = ml = self.LM_MULT * mf
        self.feat_xy = np.zeros((mf, 2), np.float32)
        self.feat_id = np.full(mf, -1, np.int64)
        self.feat_valid = np.zeros(mf, bool)
        self.next_id = 0
        self.prev_image: np.ndarray | None = None
        # feature-churn counters (tracing/diagnostics; reset at will)
        self.track_stats = {"klt_killed": 0, "ransac_killed": 0,
                            "border_killed": 0, "detected": 0}

        # fisheye image-circle mask (the reference's `fisheye: 1` +
        # fisheye_mask.jpg contract, euroc_config.yaml:41): features outside
        # the circle are invalid and never re-detected there
        self._mask_center = None
        self._mask_r2 = None
        if getattr(cfg, "fisheye", False):
            c_ = cfg.camera
            r = float(getattr(cfg, "fisheye_mask_radius", 0.0)) or min(
                float(c_.cx), float(c_.cy),
                c_.width - float(c_.cx), c_.height - float(c_.cy))
            self._mask_center = (float(c_.cx), float(c_.cy))
            self._mask_r2 = r * r

        # sliding window state
        w = self.WINDOW
        self.kf_count = 0          # total keyframes ever
        self.n_in_window = 0
        self.state = ba.WindowState(
            p=jnp.zeros((w, 3)), q=jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (w, 1)),
            v=jnp.zeros((w, 3)), bg=jnp.zeros((w, 3)), ba=jnp.zeros((w, 3)),
            lm=jnp.zeros((ml, 3)), kf_valid=jnp.zeros(w, bool),
            lm_valid=jnp.zeros(ml, bool))
        self.obs = np.zeros((w, ml, 2), np.float32)
        self.vis = np.zeros((w, ml), bool)
        self.lm_id = np.full(ml, -1, np.int64)   # landmark slot -> feature id
        self.pre_list: list = [None] * (w - 1)   # preintegrations between KFs
        self.initialized = False
        self.vi_initialized = False   # gyro-bias + gravity/scale bootstrap done
        self._last_solved = None
        # camera-only marginalization prior (VINS design: landmarks never
        # enter the prior; see `window_ba.CamPriorFactor`)
        self._prior: ba.CamPriorFactor | None = None
        self._post_boot = 0        # keyframes solved since the VI bootstrap
        self._sfm_rng = jax.random.PRNGKey(4242)   # pre-init RANSAC stream

        # camera-rate tracking state (`process_frame`): IMU accumulated since
        # the last keyframe, the last keyframe's feature snapshot for the
        # parallax decision, and the propagated IMU pose for KLT seeding
        self._imu_buf: list = []          # (gyr, acc, dt) row tuples
        self._kf_t: float | None = None   # last keyframe timestamp
        self._kf_feat_xy: dict = {}       # feature id -> pixel at last KF
        self._kf_norm: dict = {}          # feature id -> normalized at KF
        self._kf_state = None             # (p, q, v, bg, ba) at last KF

        # one fused jit for the packet's image work (blur + window BRIEF +
        # FAST + full-image BRIEF + undistort-lift) on fixed-capacity arrays
        cell = max(8, cfg.min_feature_dist // 2)
        # loop-closure features are budgeted independently of the tracker
        # (`server_keyframe.cpp:267-290` extracts all corners at thresh 20)
        max_ext = max(int(getattr(cfg, "loop_features", 512)),
                      self.MAX_FEAT * 2)

        def _emit_compute(img, win_px, thresh):
            blurred = brief.gaussian_blur(img, 2.0, radius=4)
            wdesc = brief.compute_brief(blurred, win_px, pre_blurred=True)
            score = fast.fast_score_map(img, thresh)
            kps = fast.select_keypoints(score, max_num=max_ext, cell=cell)
            edesc = brief.compute_brief(blurred, kps.xy, pre_blurred=True)
            euv = self.cam.lift(kps.xy)
            return wdesc, kps.xy, kps.valid, edesc, euv

        self._emit_compute = jax.jit(_emit_compute)

        # re-detection as one jitted program with a FIXED candidate budget:
        # asking for exactly n_free keypoints re-specialized the top-k per
        # distinct free-slot count (a recompile nearly every frame once the
        # tracker churns); the fill loop below takes what it needs
        def _redetect_compute(img, thresh, existing_xy, existing_valid):
            score = fast.fast_score_map(img, thresh)
            return fast.select_keypoints(
                score, max_num=mf, cell=cfg.min_feature_dist,
                existing_xy=existing_xy, existing_valid=existing_valid,
                min_dist=float(cfg.min_feature_dist))

        self._redetect_compute = jax.jit(_redetect_compute)

    # ---------- feature maintenance ----------

    def _apply_fisheye_mask(self):
        """Kill features outside the fisheye image circle (the reference's
        `fisheye: 1` + fisheye_mask.jpg tracker gate)."""
        if self._mask_r2 is None:
            return
        cx, cy = self._mask_center
        d2 = ((self.feat_xy[:, 0] - cx) ** 2
              + (self.feat_xy[:, 1] - cy) ** 2)
        self.feat_valid &= d2 <= self._mask_r2

    def _predict_features(self, p_pred: np.ndarray, q_pred: np.ndarray,
                          p_prev: np.ndarray, q_prev: np.ndarray):
        """Predicted pixel positions of current features in the new frame —
        the VINS predicted-flow KLT seed, fully vectorized:

        - landmark reprojection where the feature has a triangulated 3-D
          point;
        - otherwise, the feature's ray from the previous frame is carried
          through the IMU-predicted relative pose at the median landmark
          depth (rotation handles most of the flow; the depth prior
          approximates the translational part). Without a seed, inter-frame
          flow here (~35 px at 2 Hz) exceeds the pyramid's capture range on
          band-limited texture."""
        if not self.feat_valid.any():
            return None
        fv = self.feat_valid
        r_wb1 = np.asarray(quat_to_matrix(jnp.asarray(q_pred, jnp.float32)))
        r_wb0 = np.asarray(quat_to_matrix(jnp.asarray(q_prev, jnp.float32)))
        lm = np.asarray(self.state.lm)
        lm_ok = np.asarray(self.state.lm_valid) & (self.lm_id >= 0)
        if not self.vi_initialized:
            # pre-bootstrap the visual frame has no metric scale, so the
            # IMU-integrated translation (metric) is inconsistent with it and
            # triangulated depths are unreliable: predict rotation-only
            # (gyro is trustworthy from frame 0 and carries ~all of the flow)
            p_pred = p_prev
            lm_ok = np.zeros_like(lm_ok)

        # feature slot -> landmark slot (by shared feature id)
        match = (self.feat_id[:, None] == self.lm_id[None, :]) & lm_ok[None, :]
        has_lm = match.any(axis=1) & fv
        lm_slot = np.argmax(match, axis=1)

        # per-feature depth: its landmark's depth in the PREVIOUS camera, or
        # the median depth of all valid landmarks (5 m fallback)
        rays = np.ones((self.MAX_FEAT, 3), np.float32)
        rays[:, :2] = np.asarray(self.cam.lift(jnp.asarray(self.feat_xy)))
        pts_b0 = (lm - p_prev[None, :]) @ r_wb0          # world -> prev body
        pts_c0 = (pts_b0 - self.p_bc[None, :]) @ self.r_cb.T
        depths = pts_c0[:, 2]
        good_d = lm_ok & (depths > 0.1)
        med_d = float(np.median(depths[good_d])) if good_d.any() else 5.0
        feat_d = np.where(has_lm, depths[lm_slot], med_d).astype(np.float32)
        feat_d = np.maximum(feat_d, 0.3)

        # 3-D point per feature: its landmark if known, else ray * depth
        # (NaNs from dead slots/rays are benign — gated by the isfinite
        # check below — but keep them out of the numpy warning machinery)
        with np.errstate(invalid="ignore"):
            pt_c0 = rays * feat_d[:, None]
            pt_w = (pt_c0 @ self.r_cb + self.p_bc[None, :]) @ r_wb0.T + p_prev
            pt_w = np.where(has_lm[:, None], lm[lm_slot], pt_w)

            # project into the predicted new frame
            pt_b1 = (pt_w - p_pred[None, :]) @ r_wb1
            pt_c1 = (pt_b1 - self.p_bc[None, :]) @ self.r_cb.T
        px = np.asarray(self.cam.project(jnp.asarray(pt_c1, jnp.float32)))
        ok = fv & (pt_c1[:, 2] > 0.1) & np.isfinite(px).all(axis=1)
        return np.where(ok[:, None], px, self.feat_xy).astype(np.float32)

    def _track_and_detect(self, image: np.ndarray,
                          init_xy: np.ndarray | None = None,
                          fb_thresh: float = 1.5):
        cfg = self.cfg
        stats = self.track_stats
        img_j = jnp.asarray(image, jnp.float32)
        if self.prev_image is not None and self.feat_valid.any():
            prev_xy = self.feat_xy.copy()
            n0 = int(self.feat_valid.sum())
            res = klt.track_points(jnp.asarray(self.prev_image, jnp.float32),
                                   img_j, jnp.asarray(self.feat_xy),
                                   jnp.asarray(self.feat_valid),
                                   levels=4, iters=15, fb_thresh=fb_thresh,
                                   max_residual=35.0,
                                   init_xy=(jnp.asarray(init_xy)
                                            if init_xy is not None else None))
            self.feat_xy = np.array(res.xy)      # writable host copies
            self.feat_valid = np.array(res.valid)
            stats["klt_killed"] += n0 - int(self.feat_valid.sum())
            # VINS rejectWithF: fundamental-matrix RANSAC over the frame
            # pair kills KLT locks onto the wrong structure BEFORE they
            # reach the window solve (photometric residual alone passes
            # them; measured as multi-thousand solve-cost spikes on
            # tracking-churn keyframes)
            if self.feat_valid.sum() >= 12:
                from ..ops import ransac as ransac_mod
                uv0 = np.asarray(self.cam.lift(jnp.asarray(prev_xy)))
                uv1 = np.asarray(self.cam.lift(jnp.asarray(self.feat_xy)))
                self._sfm_rng, k1 = jax.random.split(self._sfm_rng)
                fr = ransac_mod.fundamental_ransac(
                    jnp.asarray(uv0), jnp.asarray(uv1),
                    jnp.asarray(self.feat_valid), k1,
                    inlier_thresh=(3.0 / float(self.cam.fx)) ** 2)
                if int(fr.num_inliers) >= 12:
                    n1 = int(self.feat_valid.sum())
                    self.feat_valid &= np.asarray(fr.inliers)
                    stats["ransac_killed"] += n1 - int(self.feat_valid.sum())
        # drop features too close to the border for BRIEF
        b = brief.PATCH_HALF + 1
        inb = ((self.feat_xy[:, 0] >= b) & (self.feat_xy[:, 0] < image.shape[1] - b)
               & (self.feat_xy[:, 1] >= b) & (self.feat_xy[:, 1] < image.shape[0] - b))
        n2 = int(self.feat_valid.sum())
        self.feat_valid &= inb
        self._apply_fisheye_mask()
        stats["border_killed"] += n2 - int(self.feat_valid.sum())
        # re-detect into free slots (fixed-budget jitted program; the fill
        # loop consumes candidates until the free slots run out). NOTE: do
        # NOT lower the FAST threshold when starved — A/B on the nuisance
        # world measured sub-threshold corners dragging ATE 19.6 -> 47 cm
        # (weak corners under blur/noise make bad landmarks, and the window
        # solve weighs them like good ones)
        n_free = int((~self.feat_valid).sum())
        if n_free > 0:
            kps = self._redetect_compute(
                img_j, jnp.asarray(cfg.fast_threshold, jnp.float32),
                jnp.asarray(self.feat_xy), jnp.asarray(self.feat_valid))
            new_xy = np.asarray(kps.xy)
            new_ok = np.array(kps.valid)  # writable copy
            new_ok &= ((new_xy[:, 0] >= b) & (new_xy[:, 0] < image.shape[1] - b)
                       & (new_xy[:, 1] >= b) & (new_xy[:, 1] < image.shape[0] - b))
            if self._mask_r2 is not None:
                cx, cy = self._mask_center
                new_ok &= ((new_xy[:, 0] - cx) ** 2
                           + (new_xy[:, 1] - cy) ** 2) <= self._mask_r2
            free_slots = np.nonzero(~self.feat_valid)[0]
            k = 0
            for j in range(len(new_xy)):
                if not new_ok[j] or k >= len(free_slots):
                    continue
                s = free_slots[k]
                self.feat_xy[s] = new_xy[j]
                self.feat_id[s] = self.next_id
                self.next_id += 1
                self.feat_valid[s] = True
                k += 1
            stats["detected"] += k
        self.prev_image = image

    # ---------- window management ----------

    def _marginalize_oldest(self):
        """Schur-marginalize the leaving keyframe (and the landmarks dying
        with it) into a CAMERA-ONLY linearized prior over the shifted window
        — the fixed-lag-smoother consistency step (VINS marginalization,
        `marginalization_factor.cpp`: the prior spans pose/velocity/bias
        blocks only, never landmarks). Without it the window simply forgets
        everything older than WINDOW keyframes and the trajectory
        random-walks between solves."""
        st = self.state
        meas = self._build_meas()
        k = self.WINDOW
        dying = self.vis[0] & ~self.vis[1:].any(axis=0)
        j, r0 = ba.marginalize_prior_cam(st, meas, jnp.asarray(dying))
        j = np.asarray(j)
        if not (np.isfinite(j).all() and np.isfinite(np.asarray(r0)).all()):
            # a numerically-broken prior poisons every later solve (NaN
            # cost); dropping one marginalization step only loses a little
            # smoothing information
            return None
        # re-index columns into the post-shift layout: kf slot s -> s-1
        # within each of the 5 camera blocks; the newest slot unconstrained
        jn = np.zeros_like(j)
        for b in range(5):
            o = 3 * k * b
            jn[:, o:o + 3 * (k - 1)] = j[:, o + 3:o + 3 * k]
        roll_np = lambda a: np.concatenate([a[1:], a[-1:]], axis=0)
        return ba.CamPriorFactor(
            j=jnp.asarray(jn), r0=jnp.asarray(r0),
            p=jnp.asarray(roll_np(np.asarray(st.p))),
            q=jnp.asarray(roll_np(np.asarray(st.q))),
            v=jnp.asarray(roll_np(np.asarray(st.v))),
            bg=jnp.asarray(roll_np(np.asarray(st.bg))),
            ba=jnp.asarray(roll_np(np.asarray(st.ba))))

    def _shift_window(self):
        """Fixed-lag slide: marginalize the oldest keyframe into the prior,
        then drop it (roll arrays)."""
        if self.initialized and self.vi_initialized:
            self._prior = self._marginalize_oldest()
        roll = lambda a: jnp.concatenate([a[1:], a[-1:]], axis=0)
        st = self.state
        self.state = st._replace(
            p=roll(st.p), q=roll(st.q), v=roll(st.v), bg=roll(st.bg),
            ba=roll(st.ba),
            kf_valid=jnp.concatenate([st.kf_valid[1:], jnp.zeros(1, bool)]))
        self.obs = np.concatenate([self.obs[1:], np.zeros_like(self.obs[:1])])
        self.vis = np.concatenate([self.vis[1:], np.zeros_like(self.vis[:1])])
        self.pre_list = self.pre_list[1:] + [None]
        self.n_in_window -= 1
        # landmarks no longer observed anywhere leave the window (the prior
        # is camera-only, so no prior column bookkeeping is needed)
        seen = self.vis.any(axis=0)
        self.state = self.state._replace(
            lm_valid=self.state.lm_valid & jnp.asarray(seen))
        self.lm_id[~seen] = -1

    def _visual_pose_init(self, slot: int):
        """Pre-VI-init pose for the new slot from VISION (VINS-Mono's SfM
        initialization stage): PnP against already-triangulated landmarks
        when enough are visible (keeps the visual frame's scale consistent),
        else essential-matrix decomposition against the previous frame (the
        first pair defines the arbitrary visual scale)."""
        from ..ops import ransac as ransac_mod
        st = self.state
        prev = slot - 1
        if prev < 0:
            return
        self._sfm_rng, k1 = jax.random.split(self._sfm_rng)
        lm_valid = np.asarray(st.lm_valid)
        vis_new = self.vis[slot] & lm_valid
        if vis_new.sum() >= 10:
            res = ransac_mod.pnp_ransac(
                st.lm, jnp.asarray(self.obs[slot]), jnp.asarray(vis_new), k1,
                inlier_thresh=4.0 / self.cam.fx, min_inliers=8)
            if bool(res.ok):
                r_cw = np.asarray(res.r)
                r_wb = r_cw.T @ self.r_cb          # R_cw = r_cb R_wb^T
                c_w = -r_cw.T @ np.asarray(res.t)  # camera center, world
                p = c_w - r_wb @ self.p_bc
                self._set_slot_pose(slot, r_wb, p)
                return
        common = self.vis[prev] & self.vis[slot]
        if common.sum() >= 8:
            self._sfm_rng, k2 = jax.random.split(self._sfm_rng)
            res = ransac_mod.essential_pose(
                jnp.asarray(self.obs[prev]), jnp.asarray(self.obs[slot]),
                jnp.asarray(common), k2)
            if bool(res.ok):
                r = np.asarray(res.r)              # R_c1<-c0
                tdir = np.asarray(res.t)
                r_wb0 = quat_to_matrix_np(np.asarray(st.q[prev]))
                r_wc0 = r_wb0 @ self.r_cb.T
                c0 = np.asarray(st.p[prev]) + r_wb0 @ self.p_bc
                # |t| is unobservable: keep the IMU-predicted displacement
                # magnitude (floored) — the first pair fixes the visual scale
                scale = max(float(np.linalg.norm(
                    np.asarray(st.p[slot]) - np.asarray(st.p[prev]))), 0.05)
                r_wc1 = r_wc0 @ r.T
                c1 = c0 + r_wc0 @ (-r.T @ tdir) * scale
                r_wb1 = r_wc1 @ self.r_cb
                p1 = c1 - r_wb1 @ self.p_bc
                self._set_slot_pose(slot, r_wb1, p1)

    def _set_slot_pose(self, slot: int, r_wb: np.ndarray, p: np.ndarray):
        from ..geometry.hostmath import matrix_to_quat_np
        st = self.state
        q = matrix_to_quat_np(r_wb).astype(np.float32)
        dtp = self.pre_list[slot - 1]
        dt = float(dtp.dt) if dtp is not None else 0.5
        v = (p - np.asarray(st.p[slot - 1])) / max(dt, 1e-3)
        self.state = st._replace(
            p=st.p.at[slot].set(jnp.asarray(p, jnp.float32)),
            q=st.q.at[slot].set(jnp.asarray(q)),
            v=st.v.at[slot].set(jnp.asarray(v, jnp.float32)))

    def _imu_init_attitude(self, acc: np.ndarray):
        """Gravity-aligned initial orientation (`server_utility.cpp` g2R)."""
        g_meas = acc.mean(axis=0)
        # stationary accel reads R_wb^T * (0,0,9.81); g2r maps that direction
        # onto +z with zero yaw, i.e. it IS R_wb (up to yaw, which is free)
        r = np.asarray(g2r(jnp.asarray(g_meas, jnp.float32)))
        return np.asarray(matrix_to_quat(jnp.asarray(r, jnp.float32)))

    # ---------- main entry ----------

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        if self.cfg.equalize:
            # global photometric normalization (the `equalize: 1` role,
            # euroc_config.yaml:47): auto-exposure gain flicker otherwise
            # violates KLT's brightness-constancy and shifts FAST thresholds
            m = float(image.mean())
            s = float(image.std())
            image = np.clip((image - m) * (48.0 / max(s, 1.0)) + 110.0,
                            0.0, 255.0).astype(np.float32)
        return image

    def process_keyframe(self, timestamp: float, image: np.ndarray,
                         imu_gyr: np.ndarray, imu_acc: np.ndarray,
                         imu_dts: np.ndarray) -> KeyframePacket | None:
        """Feed one keyframe-rate image + the IMU batch since the previous
        keyframe. Returns a KeyframePacket once the window is solvable."""
        image = self._preprocess(image)
        return self._ingest_keyframe(timestamp, image, imu_gyr, imu_acc,
                                     imu_dts, tracked=False)

    def _ingest_keyframe(self, timestamp: float, image: np.ndarray,
                         imu_gyr: np.ndarray, imu_acc: np.ndarray,
                         imu_dts: np.ndarray,
                         tracked: bool) -> KeyframePacket | None:
        """Window update for a frame already promoted to keyframe. `tracked`:
        features were already tracked onto `image` (camera-rate path)."""
        w, mf = self.WINDOW, self.MAX_FEAT

        slot = min(self.n_in_window, w - 1)
        if self.n_in_window == w:
            self._shift_window()
            slot = w - 1

        # preintegrate IMU from previous keyframe (before tracking: the
        # predicted motion seeds the KLT search)
        if self.kf_count > 0 and len(imu_gyr):
            m = self.MAX_IMU
            g = np.zeros((m, 3), np.float32)
            a = np.zeros((m, 3), np.float32)
            dt = np.zeros(m, np.float32)
            vmask = np.zeros(m, bool)
            n = min(len(imu_gyr), m)
            g[:n], a[:n], dt[:n], vmask[:n] = (imu_gyr[:n], imu_acc[:n],
                                               imu_dts[:n], True)
            bg0 = self.state.bg[max(slot - 1, 0)]
            ba0 = self.state.ba[max(slot - 1, 0)]
            pre = imu_mod.preintegrate(jnp.asarray(g), jnp.asarray(a),
                                       jnp.asarray(dt), bg0, ba0,
                                       noise=self.cfg.imu,
                                       sample_valid=jnp.asarray(vmask))
            self.pre_list[slot - 1] = pre
        else:
            pre = None

        # pose init for the new keyframe
        st = self.state
        if self.kf_count == 0:
            q0 = self._imu_init_attitude(imu_acc if len(imu_acc) else
                                         np.array([[0, 0, 9.81]]))
            st = st._replace(
                q=st.q.at[0].set(jnp.asarray(q0)),
                kf_valid=st.kf_valid.at[0].set(True))
            p_pred = st.p[0]
            q_pred = st.q[0]
        else:
            prev = slot - 1
            if pre is not None:
                # IMU dead-reckoning prediction
                dtot = pre.dt
                p_pred = (st.p[prev] + st.v[prev] * dtot
                          + 0.5 * jnp.asarray(imu_mod.GRAVITY) * dtot * dtot
                          + quat_to_matrix(st.q[prev]) @ pre.dp)
                from ..geometry import quat_multiply, quat_normalize
                q_pred = quat_normalize(quat_multiply(st.q[prev], pre.dq))
                v_pred = (st.v[prev] + jnp.asarray(imu_mod.GRAVITY) * dtot
                          + quat_to_matrix(st.q[prev]) @ pre.dv)
            else:
                p_pred, q_pred, v_pred = st.p[prev], st.q[prev], st.v[prev]
            st = st._replace(
                p=st.p.at[slot].set(p_pred), q=st.q.at[slot].set(q_pred),
                v=st.v.at[slot].set(v_pred),
                bg=st.bg.at[slot].set(st.bg[prev]),
                ba=st.ba.at[slot].set(st.ba[prev]),
                kf_valid=st.kf_valid.at[slot].set(True))

        # track with IMU/landmark-predicted feature positions, then re-detect
        # (skipped when the camera-rate path already tracked onto this frame)
        if not tracked:
            prev = max(slot - 1, 0)
            init_xy = self._predict_features(np.asarray(p_pred),
                                             np.asarray(q_pred),
                                             np.asarray(st.p[prev]),
                                             np.asarray(st.q[prev]))
            self._track_and_detect(image, init_xy)

        # observations: normalized coords of tracked features, slot-aligned
        # landmark bookkeeping by feature id
        norm_xy = np.asarray(self.cam.lift(jnp.asarray(self.feat_xy)))
        for f in range(mf):
            if not self.feat_valid[f]:
                continue
            fid = self.feat_id[f]
            lm_slot = np.nonzero(self.lm_id == fid)[0]
            if len(lm_slot) == 0:
                free = np.nonzero(self.lm_id < 0)[0]
                if len(free) == 0:
                    continue
                lm_slot = free[:1]
                self.lm_id[lm_slot[0]] = fid
            s_ = int(lm_slot[0])
            self.obs[slot, s_] = norm_xy[f]
            self.vis[slot, s_] = True

        self.state = st
        # pre-VI-init the IMU dead-reckoned baseline is near zero (unknown
        # initial velocity), which contradicts the image parallax and pushes
        # every triangulation behind the cameras: replace the new slot's pose
        # with a VISUAL estimate — PnP on existing landmarks when possible,
        # otherwise essential-matrix decomposition (the VINS-Mono SfM
        # initialization stage)
        if not self.vi_initialized and self.kf_count > 0:
            self._visual_pose_init(slot)
        self.n_in_window += 1
        self.kf_count += 1

        # triangulate landmarks with >= 2 views that aren't active yet
        # (batched: one vmapped DLT over every pending slot), then accept
        # only geometrically sound points: a bare DLT happily "solves"
        # zero-parallax rays into points thousands of meters out (or behind
        # the cameras) with near-zero residual, and those poison both the
        # window BA and every downstream PnP (the server's loop closure)
        counts = self.vis.sum(axis=0)
        lm_valid = np.array(self.state.lm_valid)
        to_tri = (counts >= 2) & ~lm_valid & (self.lm_id >= 0)
        if to_tri.any():
            pts, oks = jax.vmap(
                lambda o, v: ba.triangulate(self.state.p, self.state.q, o, v,
                                            jnp.asarray(self.r_cb),
                                            jnp.asarray(self.p_bc)),
                in_axes=(1, 1))(jnp.asarray(self.obs), jnp.asarray(self.vis))
            pts = np.asarray(pts)
            md, mr, par = ba.landmark_quality(
                self.state.p, self.state.q, self.state.kf_valid,
                jnp.asarray(self.obs), jnp.asarray(self.vis),
                jnp.asarray(pts, jnp.float32),
                jnp.asarray(self.r_cb), jnp.asarray(self.p_bc))
            # pre-bootstrap the window's estimated baseline is IMU
            # dead-reckoning from rest (near zero), so estimated parallax is
            # tiny even for good landmarks: gate only on cheirality +
            # residual until the VI alignment fixes the scale, then demand
            # real parallax
            min_par = np.deg2rad(1.0 if self.vi_initialized else 0.05)
            min_d = 0.1 if self.vi_initialized else 1e-3
            good = (to_tri & np.asarray(oks)
                    & np.isfinite(pts).all(axis=1)
                    & (np.asarray(md) > min_d)
                    & (np.asarray(mr) < 4.0 / self.cam.fx)
                    & (np.asarray(par) > min_par))
            lm = np.array(self.state.lm)
            lm[good] = pts[good]
            lm_valid |= good
            self.state = self.state._replace(
                lm=jnp.asarray(lm), lm_valid=jnp.asarray(lm_valid))

        # solve once at least 2 keyframes and some landmarks exist
        if self.n_in_window >= 2 and lm_valid.sum() >= 8:
            self._solve()
            self.initialized = True
            # one-shot VI bootstrap once the window has enough motion: gyro
            # bias from visual-vs-IMU rotations, then velocity/gravity/scale
            # (the VINS-Mono initialization the reference's agent presumes)
            if not self.vi_initialized and self.n_in_window >= min(5, w):
                self._try_vi_bootstrap()

        # packets only after visual-inertial initialization AND a short
        # settle period: pre-bootstrap window points are non-metric, and the
        # first post-bootstrap solves still carry the init transient
        # (VINS-Mono agents likewise publish only once initialized)
        if self.vi_initialized:
            self._post_boot += 1
        ready = (self.initialized and self.vi_initialized
                 and self._post_boot > self.cfg.publish_warmup)
        return self._emit_packet(timestamp, image) if ready else None

    # ---------- camera-rate tracking + keyframe selection ----------

    @full_precision
    def process_frame(self, timestamp: float, image: np.ndarray,
                      imu_gyr: np.ndarray, imu_acc: np.ndarray,
                      imu_dts: np.ndarray) -> KeyframePacket | None:
        """Camera-rate entry point — the reference's actual agent contract:
        the feature tracker runs at the FULL camera rate (20 Hz on EuRoC)
        and keyframes are selected/published at ~`freq` Hz by rotation-
        compensated parallax and track survival
        (`config/euroc/euroc_config.yaml:44-46`; VINS `keyframe_parallax`
        semantics). Tracking every frame keeps per-step KLT flow small
        (within pyramid capture range) while the window solve still runs at
        keyframe rate.

        Feed EVERY camera frame, with the IMU batch since the PREVIOUS
        FRAME. Returns a KeyframePacket when this frame was promoted to a
        keyframe and the window is publishable, else None.
        """
        image = self._preprocess(image)
        g = np.asarray(imu_gyr, np.float32).reshape(-1, 3)
        a = np.asarray(imu_acc, np.float32).reshape(-1, 3)
        d = np.asarray(imu_dts, np.float32).reshape(-1)
        for row in zip(g, a, d[:len(g)]):
            self._imu_buf.append(row)

        if self.kf_count == 0:
            pkt = self._ingest_keyframe(timestamp, image, imu_gyr, imu_acc,
                                        imu_dts, tracked=False)
            self._snapshot_keyframe(timestamp)
            return pkt

        gyr_b, acc_b, dt_b = self._imu_buf_arrays()
        p_pred, q_pred = self._propagate_from_kf(gyr_b, acc_b, dt_b)
        # seed KLT with the prediction relative to the PREVIOUS frame's
        # propagated pose (features live in the previous frame)
        p_prev, q_prev = self._prop_pose
        init_xy = self._predict_features(p_pred, q_pred, p_prev, q_prev)
        # keep the strict 1.5 px forward-backward gate at camera rate: it
        # kills ~6 %/frame (tracked count sags in low-texture spans), but
        # A/B measurement on the distorted nuisance world showed the tracks
        # it prunes are exactly the blur-slid ones that bias the solve —
        # fb=3.0 kept 99 %/frame and WORSENED ATE 19.6 -> 28.1 cm
        self._track_and_detect(image, init_xy)
        self._prop_pose = (p_pred, q_pred)

        if not self._keyframe_decision(timestamp, q_pred):
            return None
        pkt = self._ingest_keyframe(timestamp, image, gyr_b, acc_b, dt_b,
                                    tracked=True)
        self._snapshot_keyframe(timestamp)
        return pkt

    def _imu_buf_arrays(self):
        if not self._imu_buf:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros(0, np.float32))
        g = np.stack([r[0] for r in self._imu_buf])
        a = np.stack([r[1] for r in self._imu_buf])
        d = np.asarray([r[2] for r in self._imu_buf], np.float32)
        return g, a, d

    def _propagate_from_kf(self, gyr: np.ndarray, acc: np.ndarray,
                           dts: np.ndarray):
        """IMU dead-reckoned (p, q) at the current frame from the last
        keyframe's solved state — re-preintegrates the accumulated buffer
        (fixed MAX_IMU shape: one compiled program) so the per-frame
        prediction stays consistent with the keyframe-time factor."""
        p_kf, q_kf, v_kf, bg_kf, ba_kf = self._kf_state
        if len(gyr) == 0:
            return p_kf, q_kf
        m = self.MAX_IMU
        g = np.zeros((m, 3), np.float32)
        a = np.zeros((m, 3), np.float32)
        dt = np.zeros(m, np.float32)
        vmask = np.zeros(m, bool)
        n = min(len(gyr), m)
        g[:n], a[:n], dt[:n], vmask[:n] = gyr[:n], acc[:n], dts[:n], True
        pre = imu_mod.preintegrate(jnp.asarray(g), jnp.asarray(a),
                                   jnp.asarray(dt), jnp.asarray(bg_kf),
                                   jnp.asarray(ba_kf), noise=self.cfg.imu,
                                   sample_valid=jnp.asarray(vmask))
        from ..geometry import quat_multiply, quat_normalize
        r_kf = quat_to_matrix_np(q_kf)
        tt = float(pre.dt)
        p = (p_kf + v_kf * tt
             + 0.5 * np.asarray(imu_mod.GRAVITY) * tt * tt
             + r_kf @ np.asarray(pre.dp))
        q = np.asarray(quat_normalize(quat_multiply(jnp.asarray(q_kf),
                                                    pre.dq)))
        return p.astype(np.float32), q.astype(np.float32)

    def _keyframe_decision(self, timestamp: float, q_pred: np.ndarray) -> bool:
        """Promote the current frame to a keyframe? Reference semantics:
        parallax-triggered at ~freq Hz, plus a track-survival trigger and a
        max-interval failsafe."""
        cfg = self.cfg
        dt_kf = timestamp - (self._kf_t if self._kf_t is not None else -1e9)
        freq = float(getattr(cfg, "keyframe_freq", 10.0) or 10.0)
        if dt_kf < 0.8 / freq:                      # publish-rate ceiling
            return False
        if dt_kf >= float(getattr(cfg, "max_kf_interval", 1.0)):
            return True
        # survival: fraction of last-keyframe features still tracked
        alive_ids = set(int(i) for i, v in zip(self.feat_id, self.feat_valid)
                        if v)
        kf_ids = set(self._kf_feat_xy.keys())
        if kf_ids:
            survival = len(kf_ids & alive_ids) / len(kf_ids)
            if survival < float(getattr(cfg, "kf_min_survival", 0.55)):
                return True
        # rotation-compensated parallax vs the last keyframe (VINS
        # keyframe_parallax, default 10 px): rotate current rays into the
        # keyframe camera, compare against the keyframe's normalized coords
        common = [(j, int(i)) for j, (i, v) in
                  enumerate(zip(self.feat_id, self.feat_valid))
                  if v and int(i) in self._kf_norm]
        if len(common) < 8:
            return True                              # tracking collapsed
        slots = np.asarray([c[0] for c in common])
        norm_now = np.asarray(self.cam.lift(jnp.asarray(self.feat_xy)))
        rays1 = np.concatenate([norm_now[slots],
                                np.ones((len(slots), 1), np.float32)], -1)
        r_wb0 = quat_to_matrix_np(self._kf_state[1])
        r_wb1 = quat_to_matrix_np(q_pred)
        r_c0c1 = self.r_cb @ (r_wb0.T @ r_wb1) @ self.r_cb.T
        rays0 = rays1 @ r_c0c1.T
        z = np.maximum(rays0[:, 2], 1e-6)
        comp = rays0[:, :2] / z[:, None]
        ref = np.asarray([self._kf_norm[c[1]] for c in common])
        par = np.median(np.linalg.norm(comp - ref, axis=1))
        # VINS convention: `parallax * FOCAL_LENGTH >= MIN_PARALLAX` with a
        # FIXED virtual focal of 460 px, independent of the actual camera
        # (feature_manager.cpp compensatedParallax2) — so 10 px means
        # 10/460 rad of compensated angular motion
        thresh = float(getattr(cfg, "keyframe_parallax", 10.0)) / 460.0
        return bool(par >= thresh)

    def _snapshot_keyframe(self, timestamp: float):
        """Record the keyframe-time reference for the camera-rate path."""
        slot = max(self.n_in_window - 1, 0)
        st = self.state
        self._kf_t = timestamp
        self._kf_state = (np.asarray(st.p[slot]), np.asarray(st.q[slot]),
                          np.asarray(st.v[slot]), np.asarray(st.bg[slot]),
                          np.asarray(st.ba[slot]))
        self._prop_pose = (self._kf_state[0], self._kf_state[1])
        norm = np.asarray(self.cam.lift(jnp.asarray(self.feat_xy)))
        self._kf_feat_xy = {int(i): xy.copy() for i, xy, v in
                            zip(self.feat_id, self.feat_xy, self.feat_valid)
                            if v}
        self._kf_norm = {int(i): n.copy() for i, n, v in
                         zip(self.feat_id, norm, self.feat_valid) if v}
        self._imu_buf = []

    def _try_vi_bootstrap(self):
        """Gyro-bias calibration + gravity/velocity/scale alignment over the
        current window (`vio.initializer`). Applied only when the linear
        system is well-conditioned and the recovered scale is sane; the
        corrected bias/velocities/scale then seed the next window solves."""
        from . import initializer as vi_init

        w = self.WINDOW
        present = [p_ for p_ in self.pre_list if p_ is not None]
        if len(present) < 3:
            return
        valid = np.array([p_ is not None for p_ in self.pre_list[:w - 1]])
        dummy = present[0]
        pres = [p_ if p_ is not None else dummy for p_ in self.pre_list[:w - 1]]
        pre = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pres)
        kf_ok = np.asarray(self.state.kf_valid)
        valid &= kf_ok[:-1] & kf_ok[1:]
        if valid.sum() < 3:
            return

        bg = vi_init.calibrate_gyro_bias(self.state.q, pre,
                                         jnp.asarray(valid))
        if not np.isfinite(np.asarray(bg)).all() or \
                float(jnp.linalg.norm(bg)) > 0.5:
            return
        pre_c = jax.vmap(lambda p_: imu_mod.bias_corrected(p_, bg,
                                                           jnp.zeros(3)))(pre)
        res = vi_init.linear_alignment(self.state.p, self.state.q, pre_c,
                                       jnp.asarray(valid))
        s = float(res.scale)
        # gates, VINS-Mono style: conditioning + the free-gravity magnitude
        # must land near 9.81 (|g|-gate, `initial_alignment.cpp`). The scale
        # itself only gets a sanity band — the pre-bootstrap visual frame's
        # scale is ARBITRARY (set by the first essential-matrix baseline
        # floor), so a tight magnitude gate wrongly rejects clean alignments
        # (VERDICT r3: the round-3 VI-lock delay — scale 7-11 rejected for
        # 4 keyframes on the standard test world)
        if (not bool(res.ok) or not (0.01 < s < 1000.0)
                or abs(float(res.g_free_norm) - 9.81) > 1.0):
            return
        # rotate the world so the recovered gravity lands on (0,0,-9.81)
        # (yaw-free alignment), rescale to metric, install velocities+bias
        from ..geometry import g2r, matrix_to_quat, quat_multiply, quat_normalize
        r_align = g2r(-res.gravity)  # maps -g (up measured) onto +z, yaw 0
        q_align = matrix_to_quat(r_align)
        st = self.state
        rot = lambda x: jnp.einsum("ij,kj->ki", r_align, x)
        self.state = st._replace(
            p=rot(st.p) * s,
            q=jax.vmap(lambda qq: quat_normalize(quat_multiply(q_align, qq)))(st.q),
            v=rot(res.v),
            bg=jnp.tile(bg, (w, 1)),
            lm=rot(st.lm) * s)
        self.vi_initialized = True
        # the bootstrap re-gauges (rotates + rescales) the whole window, so
        # any prior linearized in the old gauge is invalid
        self._prior = None

    def _build_meas(self) -> ba.WindowMeasurements:
        """WindowMeasurements over the current window, carrying the running
        marginalization prior — shared by the solve and the marginalization
        step so both linearize the same problem."""
        w = self.WINDOW
        # stack preintegrations (identity placeholder where missing)
        pres = []
        pre_valid = np.zeros(w - 1, bool)
        dummy = None
        for i in range(w - 1):
            if self.pre_list[i] is not None:
                pres.append(self.pre_list[i])
                pre_valid[i] = True
            else:
                if dummy is None:
                    dummy = imu_mod.preintegrate(
                        jnp.zeros((2, 3)), jnp.tile(jnp.asarray([0.0, 0, 9.81]), (2, 1)),
                        jnp.full(2, 0.005), jnp.zeros(3), jnp.zeros(3),
                        noise=self.cfg.imu)
                pres.append(dummy)
        pre = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pres)
        m0 = np.asarray(quat_to_matrix(self.state.q[0]))
        return ba.WindowMeasurements(
            obs=jnp.asarray(self.obs), vis=jnp.asarray(self.vis),
            pre=pre, pre_valid=jnp.asarray(pre_valid),
            r_cb=jnp.asarray(self.r_cb), p_bc=jnp.asarray(self.p_bc),
            pix_weight=float(self.cam.fx), huber_delta=5.0,
            bias_weight=float(self.cfg.bias_weight),
            prior=self._prior,
            anchor_p=self.state.p[0],
            anchor_yaw=jnp.arctan2(m0[1, 0], m0[0, 0]))

    def _solve(self):
        iters = self.cfg.max_solver_iterations
        # solve / gate / re-solve until the observation set is clean (≤ 3
        # rounds): a contaminated first solve drags the newest pose — the
        # emitted packet would carry it (measured 25-35 cm pose spikes on
        # tracking-churn keyframes; epipolar-consistent wrong KLT locks
        # survive even rejectWithF) — and gating redistributes residuals,
        # so one pass can expose new >4 px observations.
        for _round in range(3):
            meas = self._build_meas()
            self.state, cost = ba.solve_window_fast(self.state, meas,
                                                    iters=iters)
            self._last_solved = float(cost)
            # outlier gating: kill observations whose post-solve
            # reprojection error exceeds ~4 px (the front-end contract's
            # RANSAC/chi2 role); landmarks left with < 2 views drop out
            res = ba.reprojection_residuals(self.state, meas)  # whitened
            err_px = np.asarray(jnp.linalg.norm(res, axis=-1))
            bad = (err_px > 4.0) & self.vis
            if not bad.any():
                break
            self.vis &= ~bad
            counts = self.vis.sum(axis=0)
            self.state = self.state._replace(
                lm_valid=self.state.lm_valid & jnp.asarray(counts >= 2))
        # geometric sanity after the solve: BA can push weakly-constrained
        # landmarks behind cameras or to unobservable depths — drop them from
        # the valid set (they re-triangulate on a later frame once the
        # baseline grows)
        md, _, par = ba.landmark_quality(
            self.state.p, self.state.q, self.state.kf_valid,
            jnp.asarray(self.obs), jnp.asarray(self.vis), self.state.lm,
            jnp.asarray(self.r_cb), jnp.asarray(self.p_bc))
        min_par = np.deg2rad(0.5 if self.vi_initialized else 0.02)
        min_d = 0.05 if self.vi_initialized else 1e-3
        sane = (np.asarray(md) > min_d) & (np.asarray(par) > min_par)
        self.state = self.state._replace(
            lm_valid=self.state.lm_valid & jnp.asarray(sane))

    def _emit_packet(self, timestamp: float, image: np.ndarray) -> KeyframePacket:
        slot = self.n_in_window - 1
        st = self.state
        p = np.asarray(st.p[slot])
        q = np.asarray(st.q[slot])
        # window landmarks observed in this keyframe, gated on current-frame
        # geometry: positive sane depth and small self-reprojection residual
        # (the packet's 3-D points feed the server's PnP — one garbage point
        # in the minimal sample wrecks every hypothesis it touches)
        vis_now = self.vis[slot] & np.asarray(st.lm_valid)
        feat_lookup = {self.feat_id[f]: f for f in range(self.MAX_FEAT)
                       if self.feat_valid[f]}
        lm_all = np.asarray(st.lm)
        r_wb_np = quat_to_matrix_np(q)
        pts_c_all = ((lm_all - p) @ r_wb_np - self.p_bc) @ self.r_cb.T
        z_all = pts_c_all[:, 2]
        proj = pts_c_all[:, :2] / np.maximum(z_all[:, None], 1e-6)
        self_res = np.linalg.norm(proj - self.obs[slot], axis=1)
        has_px = np.array([i in feat_lookup for i in self.lm_id])
        vis_now &= ((z_all > 0.2) & (z_all < 200.0)
                    & (self_res < 4.0 / self.cam.fx) & has_px)
        idxs = np.nonzero(vis_now)[0]
        pts3d = lm_all[idxs]
        uv = self.obs[slot][idxs]
        ids = self.lm_id[idxs]
        # descriptors at current pixel positions of those features; the blur
        # + BRIEF + FAST + lift chain runs as ONE jitted program on padded
        # fixed-capacity keypoint arrays — calling the eager ops with the
        # frame's variable keypoint count recompiled ~100 XLA executables
        # per keyframe (measured: the dominant front-end cost AND an mmap
        # exhaustion over long runs)
        img_j = jnp.asarray(image, jnp.float32)
        px = np.array([self.feat_xy[feat_lookup[i]] for i in ids],
                      np.float32).reshape(-1, 2)
        px_pad = np.zeros((self.MAX_FEAT, 2), np.float32)
        px_pad[:len(px)] = px
        wdesc, ext_xy_j, ext_ok_j, ext_desc_j, ext_uv_j = self._emit_compute(
            img_j, jnp.asarray(px_pad),
            jnp.asarray(self.cfg.fast_threshold, jnp.float32))
        desc = np.asarray(wdesc)[:len(px)]
        ext_xy = np.asarray(ext_xy_j)
        ext_ok = np.array(ext_ok_j)   # writable copy
        bmargin = brief.PATCH_HALF + 1
        ext_ok &= ((ext_xy[:, 0] >= bmargin) & (ext_xy[:, 0] < image.shape[1] - bmargin)
                   & (ext_xy[:, 1] >= bmargin) & (ext_xy[:, 1] < image.shape[0] - bmargin))
        ext_desc = np.asarray(ext_desc_j)
        ext_uv = np.asarray(ext_uv_j)
        return KeyframePacket(
            client_id=self.client_id, timestamp=timestamp,
            p_wb=p, q_wb=q, r_cb=self.r_cb, p_bc=self.p_bc,
            win_pts3d=pts3d.astype(np.float32), win_uv=uv.astype(np.float32),
            win_ids=ids.astype(np.int64), win_desc=desc,
            win_valid=np.ones(len(idxs), bool),
            ext_uv=ext_uv.astype(np.float32), ext_desc=ext_desc,
            ext_valid=ext_ok, image=image)
