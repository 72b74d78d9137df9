import dataclasses

import numpy as np
import pytest

from cvids_tpu.camera import PinholeCamera
from cvids_tpu.dense import estimator
from cvids_tpu.io import multiagent, render
from cvids_tpu.io.multiagent import look_at
from cvids_tpu.io.synthetic import Trajectory, quat_from_matrix_np
from cvids_tpu.mapping.tsdf import TsdfConfig
from cvids_tpu.server import pipeline, posegraph, vocab


H, W = 120, 160


@pytest.mark.slow
def test_full_pipeline_dense_to_mesh(tmp_path, rng):
    """Single agent orbiting the textured room: keyframes with images flow
    through the pose graph, dense depth estimation, TSDF, and mesh save."""
    cam = PinholeCamera.create(100.0, 100.0, W / 2, H / 2, (0, 0, 0, 0), W, H)
    k = np.asarray(cam.k_matrix)
    n_lm = 200
    landmarks = np.stack([rng.uniform(-4, 4, n_lm), rng.uniform(-3, 2.5, n_lm),
                          rng.uniform(0, 2, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    voc = vocab.train_vocabulary(descs, k=5, levels=2, seed=0)

    cfg = pipeline.PipelineConfig(
        server=posegraph.ServerConfig(kf_capacity=64, max_win=32, max_ext=64,
                                      max_loops=32, optimize_every=10000),
        dense=estimator.DenseConfig(height=H, width=W, num_depths=48,
                                    dep_sample=(1.0 / 0.6 - 1.0 / 8.0) / 48,
                                    pi1=4.0, pi2=16.0, tau2_scale=0.5),
        tsdf=TsdfConfig(voxel_size=0.12, capacity=4096, carving=False),
        min_fused_frames=2, ref_advance=3)
    server = pipeline.CollaborativeServer(voc, cfg)
    server.set_client_intrinsics(0, k)

    r_cb = multiagent.R_CB_DEFAULT
    target = np.array([1.5, 1.0, 0.5])
    n_kf = 14
    for i in range(n_kf):
        ang = -0.6 + 1.2 * i / n_kf
        eye = np.array([1.5 + 1.5 * np.sin(ang), -2.2, 1.2])
        r_wc = look_at(eye, target)
        inten, depth_gt = render.render_textured_scene(cam, r_wc, eye)
        # body pose from camera pose: r_wb = r_wc @ r_cb (x_cam = r_cb x_body)
        r_wb = r_wc @ r_cb
        q_wb = quat_from_matrix_np(r_wb)
        # visible landmark window points (server needs them for the packet)
        pts_b = (landmarks - eye) @ r_wb
        pts_c = pts_b @ r_cb.T
        good = pts_c[:, 2] > 0.5
        idxs = np.nonzero(good)[0][:30]
        uv = pts_c[idxs, :2] / pts_c[idxs, 2:3]
        pkt = multiagent.KeyframePacket(
            client_id=0, timestamp=float(i), p_wb=eye.astype(np.float32),
            q_wb=q_wb.astype(np.float32), r_cb=r_cb,
            p_bc=np.zeros(3, np.float32),
            win_pts3d=landmarks[idxs].astype(np.float32),
            win_uv=uv.astype(np.float32), win_ids=idxs.astype(np.int64),
            win_desc=descs[idxs], win_valid=np.ones(len(idxs), bool),
            ext_uv=uv.astype(np.float32), ext_desc=descs[idxs],
            ext_valid=np.ones(len(idxs), bool), image=inten)
        server.submit(pkt)
    n = server.process()
    assert n == n_kf
    assert server.depth_maps_published >= 2, server.depth_maps_published
    assert len(server.volume.slot_of) > 20

    # mesh contains the floor near z=0
    path = str(tmp_path / "mesh.ply")
    n_tris = server.save_mesh(path)
    assert n_tris > 100
    from cvids_tpu.mapping.mesh import read_ply
    verts, _, _ = read_ply(path)
    floor = verts[np.abs(verts[:, 2]) < 0.1]
    assert len(floor) > 50
    # tracer collected the reference's stage taxonomy
    rep = server.tracer.report()
    assert "ingest" in rep and "depth" in rep


def test_disturbance_injection(rng, tmp_path):
    """AddDisturbance fires once the store reaches the threshold."""
    n_lm = 60
    landmarks = np.stack([rng.uniform(-10, 10, n_lm), rng.uniform(-10, 10, n_lm),
                          rng.uniform(0.2, 3, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    voc = vocab.train_vocabulary(descs, k=5, levels=2, seed=0)
    cfg = pipeline.PipelineConfig(
        server=posegraph.ServerConfig(kf_capacity=64, max_win=32, max_ext=64,
                                      max_loops=32, optimize_every=10000),
        dense_enabled=False, disturbance_after=10)
    server = pipeline.CollaborativeServer(voc, cfg)
    agents = [multiagent.AgentSim(Trajectory.circle(radius=5.0, omega=0.5))]
    packets, gt = multiagent.generate_packets(agents, landmarks, descs,
                                              duration=20.0, kf_rate=1.0,
                                              max_feats=30)
    yaw_before = None
    for _, _, ki, pkt in packets:
        if server.graph.store.count == 10 and server.graph.loop_count > 0:
            yaw_before = server.graph.loop_yaw[:server.graph.loop_count].copy()
        # tiny images so the loop-overlay diagnostic path is exercised
        server.submit(dataclasses.replace(pkt, image=rng.uniform(0, 255, (24, 32))))
        server.process()
    if yaw_before is not None and len(yaw_before):
        after = server.graph.loop_yaw[:len(yaw_before)]
        assert np.allclose(after - yaw_before, np.deg2rad(0.2), atol=1e-6)
    if server.graph.last_loop is not None:
        assert server._loop_overlay_pair is not None
        p = str(tmp_path / "loop_overlay.png")
        ok = server.save_loop_overlay(p)
        if ok:
            import os
            assert os.path.getsize(p) > 1000


def test_rendered_orbit_stream_is_consistent():
    """Each packet's window points, seen from the packet's own local-frame
    pose, project to its normalized uv; the local frames hide a per-agent
    yaw + translation from the world."""
    from cvids_tpu.geometry.hostmath import quat_to_matrix_np

    cam = PinholeCamera.create(46.1, 46.1, 40.0, 30.0, (0, 0, 0, 0), 80, 60)
    packets, gt, descs = multiagent.rendered_orbit_stream(
        cam, n_agents=2, n_kf=3, n_landmarks=300, seed=1)
    assert len(packets) == 6 and descs.shape == (300, 8)
    assert [p.timestamp for p in packets] == sorted(p.timestamp for p in packets)
    for p in packets:
        assert p.image.shape == (60, 80) and len(p.win_uv) >= 10
        r_lb = quat_to_matrix_np(p.q_wb)
        pts_c = (p.win_pts3d - p.p_wb) @ r_lb @ np.asarray(p.r_cb).T
        np.testing.assert_allclose(pts_c[:, :2] / pts_c[:, 2:3], p.win_uv,
                                   atol=1e-4)
        eye, _ = gt[(p.client_id, round(p.timestamp * 10))]
        assert np.linalg.norm(p.p_wb - eye) > 0.5   # local != world
