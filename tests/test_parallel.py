import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvids_tpu.parallel import (
    make_mesh,
    pad_edges_for_sharding,
    shard_posegraph_solve,
)
from cvids_tpu.server import optimizer as opt


def build_graph(rng, n=64):
    import sys
    sys.path.insert(0, "tests")
    from test_posegraph_opt import simulate_drifting_chain
    yaw_gt, t_gt, yaw_est, t_est = simulate_drifting_chain(rng, n)
    nodes = opt.PoseGraphNodes(
        yaw=jnp.asarray(yaw_est, jnp.float32), pr=jnp.zeros((n, 2), jnp.float32),
        t=jnp.asarray(t_est, jnp.float32), valid=jnp.ones(n, bool),
        fixed=jnp.arange(n) == 0)
    seq = opt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t,
                                    jnp.zeros(n, jnp.int32), nodes.valid)
    li = np.array([0, 3], np.int32)
    lj = np.array([n - 1, n - 4], np.int32)
    t_ij, yaw_ij = [], []
    for a, b in zip(li, lj):
        r_a = np.array([[np.cos(yaw_gt[a]), -np.sin(yaw_gt[a]), 0],
                        [np.sin(yaw_gt[a]), np.cos(yaw_gt[a]), 0], [0, 0, 1]])
        t_ij.append(r_a.T @ (t_gt[b] - t_gt[a]))
        yaw_ij.append(yaw_gt[b] - yaw_gt[a])
    loops = opt.PoseGraphEdges(
        i=jnp.asarray(li), j=jnp.asarray(lj),
        t_ij=jnp.asarray(np.stack(t_ij), jnp.float32),
        yaw_ij=jnp.asarray(np.asarray(yaw_ij), jnp.float32),
        t_weight=jnp.full(2, 5.0, jnp.float32),
        yaw_weight=jnp.full(2, 5.0, jnp.float32),
        valid=jnp.ones(2, bool), huber=jnp.full(2, jnp.inf, jnp.float32))
    edges = opt.PoseGraphEdges(*[jnp.concatenate([a, b]) for a, b in zip(seq, loops)])
    return nodes, edges, t_gt


def test_mesh_uses_all_devices():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8


def test_sharded_solve_matches_single_device(rng):
    nodes, edges, t_gt = build_graph(rng)
    ref = opt.optimize_pose_graph(nodes, edges, lm_iters=8, cg_iters=40)

    mesh = make_mesh(8)
    edges_p = pad_edges_for_sharding(edges, 8)
    solve = shard_posegraph_solve(mesh, lm_iters=8, cg_iters=40)
    out = solve(nodes, edges_p)
    np.testing.assert_allclose(np.asarray(out.t), np.asarray(ref.t), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.yaw), np.asarray(ref.yaw), atol=2e-3)


def test_pad_edges_invalid_padding(rng):
    nodes, edges, _ = build_graph(rng, n=16)
    e0 = edges.i.shape[0]
    padded = pad_edges_for_sharding(edges, 8)
    assert padded.i.shape[0] % 8 == 0
    assert not np.asarray(padded.valid[e0:]).any()
    # padded edges don't change residuals
    r0 = np.asarray(opt.edge_residuals(nodes, edges))
    r1 = np.asarray(opt.edge_residuals(nodes, padded))
    np.testing.assert_allclose(r1[:e0], r0)
    np.testing.assert_allclose(r1[e0:], 0.0)


def test_sharded_dense_fuse_agents(rng):
    from cvids_tpu.dense import estimator
    from cvids_tpu.parallel import sharded_dense_fuse
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(8)
    cfg = estimator.DenseConfig(height=16, width=16, num_depths=8)
    n_agents = 8
    refs = jnp.asarray(rng.uniform(0, 255, (n_agents, 16, 16)), jnp.float32)
    states = jax.vmap(lambda r: estimator.init_reference(cfg, r))(refs)
    k = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    a = jnp.tile(jnp.asarray(k @ np.linalg.inv(k))[None], (n_agents, 1, 1))
    b = jnp.tile(jnp.asarray(k @ np.array([-0.1, 0, 0], np.float32))[None],
                 (n_agents, 1))
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    refs_s = jax.device_put(refs, shard)
    fuse = sharded_dense_fuse(mesh, cfg)
    out = fuse(states, refs_s, a, b)
    assert np.asarray(out.num_frames).tolist() == [1] * n_agents
    assert np.isfinite(np.asarray(out.filt.mu)).all()
    # the agent axis stays sharded: each device holds its own agent's state
    assert out.filt.mu.sharding.is_equivalent_to(shard, 3)
    assert len(out.mean_cost.addressable_shards) == 8


def test_sharded_window_schur_matches_single_device(rng):
    """Landmark-sharded Schur VI-BA on an 8-device mesh reaches the same
    optimum as the single-device Schur solver (`vio.window_ba`)."""
    from cvids_tpu.parallel import make_mesh, solve_window_schur_sharded
    from cvids_tpu.vio import window_ba as ba
    from tests.test_vio import _build_problem, make_seq

    seq = make_seq(duration=5.0, num_landmarks=40, seed=3)
    state, meas = _build_problem(seq, perturb=0.1, rng=rng)
    ref_out, ref_cost = ba.solve_window_schur(state, meas, iters=10)

    mesh = make_mesh(8, axis="lms")
    sh_out, sh_cost = solve_window_schur_sharded(mesh, state, meas, iters=10)

    assert float(sh_cost) < 1.2 * float(ref_cost) + 5.0
    assert np.allclose(np.asarray(sh_out.p), np.asarray(ref_out.p),
                       atol=5e-2), np.abs(
        np.asarray(sh_out.p) - np.asarray(ref_out.p)).max()
    lmv = np.asarray(state.lm_valid)
    assert np.allclose(np.asarray(sh_out.lm)[lmv],
                       np.asarray(ref_out.lm)[lmv], atol=1e-1)


def test_production_phases_four_devices_match_one():
    """The sharded programs `chip_smoke.py --four-cards` runs (small shapes):
    a 4-device mesh gives the 1-device results within `compare_phases`'
    tolerances, and the audit names every program."""
    import __graft_entry__ as ge

    res_4 = ge.production_phases(make_mesh(4), small=True)
    res_1 = ge.production_phases(make_mesh(1), n_agents=4, small=True)
    assert len(res_4["audits"]) == 3
    for key, (summary, ok, tol) in ge.compare_phases(res_4, res_1).items():
        assert ok, f"{key}: {summary} (tolerance {tol})"
