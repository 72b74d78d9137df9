"""Synthetic multi-agent keyframe-packet streams for server testing.

Generates what N agent VIO front-ends would publish (`KeyframePacket` ≈
AgentMsg): each agent flies a closed-form trajectory through a shared
landmark field; landmarks carry fixed random 256-bit descriptors so
cross-agent matching behaves like real BRIEF matching with zero descriptor
noise (noise can be injected by flipping bits). Each agent's VIO is reported
in its own local frame — offset from the world by an undisclosed yaw+t
transform, optionally with odometric drift — exactly the situation the
collaborative server must undo.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.msgs import KeyframePacket
from .synthetic import Trajectory, quat_from_matrix_np

R_CB_DEFAULT = np.array([[0.0, -1.0, 0.0],
                         [0.0, 0.0, -1.0],
                         [1.0, 0.0, 0.0]], np.float32)  # body FLU -> cam z-fwd


def landmark_descriptors(num: int, seed: int = 99) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(num, 8), dtype=np.uint32)


def _rotz_np(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


@dataclass
class AgentSim:
    traj: Trajectory
    yaw_offset: float = 0.0      # local frame offset: p_local = Rz(-yaw) (p_w - t)
    t_offset: np.ndarray = None  # (3,)
    drift_yaw_rate: float = 0.0  # rad per keyframe of odometric drift
    drift_t_rate: float = 0.0    # m per keyframe


def generate_packets(
    agents: list[AgentSim],
    landmarks: np.ndarray,
    descriptors: np.ndarray,
    duration: float = 20.0,
    kf_rate: float = 1.0,
    fov_cos: float = 0.4,
    max_range: float = 25.0,
    max_feats: int = 120,
    pix_noise: float = 0.0,
    seed: int = 0,
):
    """Returns (packets_in_time_order, ground_truth) where ground truth maps
    (client, kf_index) -> world pose."""
    rng = np.random.default_rng(seed)
    k = int(duration * kf_rate) + 1
    times = np.arange(k) / kf_rate
    packets = []
    gt = {}
    for cid, ag in enumerate(agents):
        t_off = np.zeros(3) if ag.t_offset is None else np.asarray(ag.t_offset)
        r_lw = _rotz_np(-ag.yaw_offset)  # world -> local
        p_w, r_w, _ = ag.traj.pose(times)
        # accumulated drift (applied in the local frame, odometric style)
        for ki in range(k):
            q_w = quat_from_matrix_np(r_w[ki])
            gt[(cid, ki)] = (p_w[ki].copy(), q_w.copy())
            # local-frame pose
            p_l = r_lw @ (p_w[ki] - t_off)
            r_l = r_lw @ r_w[ki]
            # drift: rotate/translate increasingly with keyframe index
            dyaw = ag.drift_yaw_rate * ki
            dt = ag.drift_t_rate * ki * np.array([1.0, 0.5, 0.1])
            rd = _rotz_np(dyaw)
            p_l = rd @ p_l + dt
            r_l = rd @ r_l
            q_l = quat_from_matrix_np(r_l)

            # visible landmarks (camera looks along body x)
            pts_b = (landmarks - p_w[ki]) @ r_w[ki]  # world -> body
            pts_c = (pts_b) @ R_CB_DEFAULT.T
            z = pts_c[:, 2]
            d = np.linalg.norm(pts_c, axis=1)
            good = (z > 0.5) & (d < max_range) & (z / np.maximum(d, 1e-9) > fov_cos)
            idxs = np.nonzero(good)[0][:max_feats]
            uv = pts_c[idxs, :2] / pts_c[idxs, 2:3]
            if pix_noise > 0:
                uv = uv + rng.normal(0, pix_noise, uv.shape)
            # landmarks in the agent's local (drifted) frame:
            pts_l = (landmarks[idxs] - t_off) @ r_lw.T
            pts_l = pts_l @ rd.T + dt

            nv = len(idxs)
            pkt = KeyframePacket(
                client_id=cid, timestamp=float(times[ki]),
                p_wb=p_l.astype(np.float32), q_wb=q_l.astype(np.float32),
                r_cb=R_CB_DEFAULT, p_bc=np.zeros(3, np.float32),
                win_pts3d=pts_l.astype(np.float32), win_uv=uv.astype(np.float32),
                win_ids=idxs.astype(np.int64),
                win_desc=descriptors[idxs], win_valid=np.ones(nv, bool),
                ext_uv=uv.astype(np.float32), ext_desc=descriptors[idxs],
                ext_valid=np.ones(nv, bool))
            packets.append((float(times[ki]), cid, ki, pkt))
    packets.sort(key=lambda x: (x[0], x[1]))
    return packets, gt


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera axes in world (columns x right, y down, z forward) for a camera
    at `eye` looking at `target` with world z up."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, [0, 0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 1)


def rendered_orbit_stream(cam, n_agents: int, n_kf: int, *, n_landmarks=800,
                          kf_rate: float = 10.0, seed: int = 0,
                          scene: dict | None = None, max_feats: int = 160):
    """Keyframe packets with rendered images for `n_agents` agents orbiting
    the textured room of `render.render_textured_scene`.

    Agent a flies an arc of its own around the box, looking at it, and
    reports its poses in a local frame that differs from the world by an
    undisclosed yaw and translation (as `generate_packets` does). Window
    points are landmarks sampled on the scene's surfaces
    (`render.sample_scene_landmarks`), kept where the rendered depth shows
    them unoccluded, so the sparse prior and the image agree. Descriptors
    are `landmark_descriptors` (train the vocabulary on them).

    Returns (packets in time order, ground truth {(client, kf): (p_wb, r_wb)},
    descriptors (n_landmarks, 8)).
    """
    from . import render

    rng = np.random.default_rng(seed)
    scene = render.default_scene() if scene is None else scene
    landmarks = render.sample_scene_landmarks(n_landmarks, rng, scene)
    descs = landmark_descriptors(n_landmarks, seed=seed + 99)
    k = np.asarray(cam.k_matrix, np.float64)
    target = np.array([1.5, 1.0, 0.5])
    packets, gt = [], {}
    for a in range(n_agents):
        yaw_off = 0.5 + 0.7 * a
        t_off = np.array([1.0 + 0.5 * a, -2.0 + 0.3 * a, 0.1 * a])
        r_lw = _rotz_np(-yaw_off)
        start = -0.9 + 1.2 * a / max(n_agents - 1, 1)
        for i in range(n_kf):
            ang = start + 0.6 * i / max(n_kf - 1, 1)
            eye = target + np.array([3.0 * np.sin(ang), -3.0 * np.cos(ang),
                                     0.8 + 0.15 * a])
            r_wc = look_at(eye, target)
            image, depth = render.render_textured_scene(cam, r_wc, eye, scene)
            r_wb = r_wc @ R_CB_DEFAULT          # x_cam = r_cb x_body
            gt[(a, i)] = (eye.copy(), r_wb.copy())
            pts_c = (landmarks - eye) @ r_wc
            z = pts_c[:, 2]
            uvh = pts_c @ k.T
            px = uvh[:, :2] / np.maximum(uvh[:, 2:3], 1e-9)
            ui = np.round(px[:, 0]).astype(int)
            vi = np.round(px[:, 1]).astype(int)
            inside = ((z > 0.3) & (ui >= 0) & (ui < cam.width)
                      & (vi >= 0) & (vi < cam.height))
            seen = np.zeros(n_landmarks, bool)
            d_img = depth[vi[inside], ui[inside]]
            seen[inside] = np.abs(d_img - z[inside]) < 0.03 * z[inside]
            idxs = np.nonzero(seen)[0][:max_feats]
            uv = (pts_c[idxs, :2] / z[idxs, None]).astype(np.float32)
            nv = len(idxs)
            pkt = KeyframePacket(
                client_id=a, timestamp=float(i / kf_rate),
                p_wb=(r_lw @ (eye - t_off)).astype(np.float32),
                q_wb=quat_from_matrix_np(r_lw @ r_wb).astype(np.float32),
                r_cb=R_CB_DEFAULT, p_bc=np.zeros(3, np.float32),
                win_pts3d=((landmarks[idxs] - t_off) @ r_lw.T).astype(np.float32),
                win_uv=uv, win_ids=idxs.astype(np.int64),
                win_desc=descs[idxs], win_valid=np.ones(nv, bool),
                ext_uv=uv, ext_desc=descs[idxs], ext_valid=np.ones(nv, bool),
                image=image)
            packets.append(pkt)
    packets.sort(key=lambda p: (p.timestamp, p.client_id))
    return packets, gt, descs
