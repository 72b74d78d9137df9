#!/usr/bin/env python
"""On-card smoke run: the collaborative server end to end on one CUDA GPU.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the sharded production programs on a
                                       # 4-card mesh vs one card, nothing else

Phases (one process; diagnostics on earlier lines, one JSON object last):
1. device: refuse anything but a GPU; print its kind, count, name and power
   limit; set the compile cache (`JAX_COMPILATION_CACHE_DIR` if set, else
   `<repo>/.jax_cache`).
2. kernels at 480x640x128: the plane sweep against the fp32 reference on the
   CPU, the SGM kernel against `lax.scan` (fp32 and the bf16 WTA), and the
   kernel's time beside the plain form's.
3. the served path: 4 agents x 24 rendered 640x480 keyframes through
   `CollaborativeServer.submit/process`, `optimize()` and `save_mesh()` at
   the default Dense/Tsdf/Server configs; alignment, published depth, TSDF
   size, mesh-to-scene distance and ATE are asserted.
4. agent window BA (20 KF / 150 landmarks): final cost within 1 % of the
   same solve on the CPU device.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
K640 = np.array([[461.0, 0, 320], [0, 461.0, 240], [0, 0, 1]], np.float32)


def _median_ms(fn, *args, n: int = 20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _check(ok: bool, what: str):
    print(f"  {'PASS' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        raise AssertionError(what)


def _rot(ax: int, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    if ax == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


# ---------------------------------------------------------------------------
# phase 2: kernels at real widths
# ---------------------------------------------------------------------------

def phase_kernels(card: str, cfg=None, k=K640, reps: int = 20) -> dict:
    import jax
    import jax.numpy as jnp

    from cvids_tpu.dense import estimator
    from cvids_tpu.ops import costvolume, sgm
    from cvids_tpu.ops.image import gaussian_blur

    cfg = cfg or estimator.DenseConfig()
    h, w = cfg.height, cfg.width
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(SEED)
    ref = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32), 1.5)
    meas = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32), 1.5)
    inv = jnp.asarray(cfg.inv_depths)
    out = {}

    sweep = jax.jit(lambda r, m, a, b: costvolume.plane_sweep_cost(
        r, m, a, b, inv, out_dtype=cfg.jdtype))
    sweep_ref = jax.jit(lambda r, m, a, b, i: costvolume.plane_sweep_cost(
        r, m, a, b, i, out_dtype=jnp.float32))
    print(f"[sweep] production {jnp.dtype(cfg.jdtype).name} on "
          f"{jax.devices()[0].platform} vs fp32 reference on the CPU "
          f"(precision=highest), {h}x{w}x{cfg.num_depths}", flush=True)
    for name, r21, t21 in (("identity", np.eye(3, dtype=np.float32), [-0.1, 0.02, 0.01]),
                           ("rotated", _rot(0, 0.03) @ _rot(1, -0.05), [0.15, -0.05, 0.03])):
        a_mat = jnp.asarray(k @ r21 @ np.linalg.inv(k))
        b_vec = jnp.asarray(k @ np.asarray(t21, np.float32))
        c, v = sweep(ref, meas, a_mat, b_vec)
        with jax.default_matmul_precision("highest"):
            c_r, v_r = sweep_ref(*[jax.device_put(x, cpu)
                                   for x in (ref, meas, a_mat, b_vec, inv)])
        c, v, c_r, v_r = (np.asarray(x) for x in (c, v, c_r, v_r))
        both = v & v_r
        err = np.abs(c.astype(np.float32) - c_r)[both]
        print(f"  {name}: valid agreement {np.mean(v == v_r):.6f}, jointly "
              f"valid {both.mean():.4f}, |err| max {err.max():.4f} mean "
              f"{err.mean():.5f} median {np.median(err):.5f}", flush=True)
        if name == "identity":
            _check(np.mean(v == v_r) > 0.98, "identity validity agreement > 0.98")
            _check(err.max() < 0.5, "identity max |err| < 0.5 (jointly valid)")
        else:
            _check(err.mean() < 1.0, "rotated mean |err| < 1.0")
            _check(np.median(err) < 0.5, "rotated median |err| < 0.5")

    # SGM input: the cost of a stereo pair, a textured plane at 3 m seen
    # across a 0.11 m baseline (`bench.py`'s pair); unobserved hypotheses
    # at 50 as in `fuse_measurement`
    pad = 80
    tex = np.asarray(gaussian_blur(jnp.asarray(
        rng.uniform(0, 255, (h, w + 2 * pad)), jnp.float32), 1.0))
    disp = int(round(k[0, 0] * 0.11 / 3.0))
    ref_s = jnp.asarray(tex[:, pad:pad + w])
    meas_s = jnp.asarray(tex[:, pad + disp:pad + disp + w])
    c, v = sweep(ref_s, meas_s, jnp.asarray(k @ np.linalg.inv(k)),
                 jnp.asarray(k @ np.array([-0.11, 0, 0], np.float32)))
    total = jnp.where(v, c.astype(jnp.float32), 50.0)
    st = estimator.init_reference(cfg, ref_s)
    for dt in (jnp.float32, cfg.jdtype):
        cost = total.astype(dt)
        p2, p1 = sgm.sgm_penalties(st.grad, dt, cfg.pi1, cfg.pi2, cfg.tau_so,
                                   penalty_scale=st.penalty)
        kern = jax.jit(lambda c_, p_, q_: tuple(
            sgm.scan_pair(c_, p_, q_, axis=ax) for ax in (1, 0)))
        plain = jax.jit(lambda c_, p_, q_: tuple(
            sgm.scan_pair_plain(c_, p_, q_, axis=ax) for ax in (1, 0)))
        pk, pp = kern(cost, p2, p1), plain(cost, p2, p1)
        agg_k = sum(np.asarray(x, np.float32) for x in pk)
        agg_p = sum(np.asarray(x, np.float32) for x in pp)
        name = jnp.dtype(dt).name
        if dt == jnp.float32:
            vmax = float(np.abs(agg_p).max())
            d = float(np.abs(agg_k - agg_p).max())
            print(f"[sgm] fp32 kernel vs lax.scan: max |d| {d:.6g}, volume "
                  f"max {vmax:.6g} (tolerance 1e-3 x max)", flush=True)
            _check(d < 1e-3 * vmax, "SGM fp32 max |d| < 1e-3 x volume max")
        else:
            agree = float(np.mean(agg_k.argmin(-1) == agg_p.argmin(-1)))
            print(f"[sgm] {name} kernel vs lax.scan on the same {name} input "
                  f"(textured-plane stereo pair): "
                  f"WTA index agreement {agree:.6f} (tolerance >= 0.99)",
                  flush=True)
            _check(agree >= 0.99, f"SGM {name} WTA agreement >= 99 %")
            out["sgm_kernel_ms"] = _median_ms(kern, cost, p2, p1, n=reps)
            out["sgm_scan_ms"] = _median_ms(plain, cost, p2, p1, n=reps)
            print(f"[time] SGM both orientations {h}x{w}x{cfg.num_depths} "
                  f"{name}: Pallas kernel {out['sgm_kernel_ms']:.3f} ms, "
                  f"lax.scan {out['sgm_scan_ms']:.3f} ms (median of {reps}; "
                  f"card {card})", flush=True)

    a_mat = jnp.asarray(k @ np.linalg.inv(k))
    b_vec = jnp.asarray(k @ np.array([-0.11, 0, 0], np.float32))
    out["fuse_ms"] = _median_ms(
        lambda s: estimator.fuse_measurement(cfg, s, meas, a_mat, b_vec).filt.mu,
        st, n=reps)
    out["sweep_ms"] = _median_ms(sweep, ref, meas, a_mat, b_vec, n=reps)
    print(f"[time] fuse_measurement {out['fuse_ms']:.3f} ms, plane sweep "
          f"{out['sweep_ms']:.3f} ms (median of {reps}; card {card})",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3: the served path
# ---------------------------------------------------------------------------

def _scene_distance(pts: np.ndarray, scene: dict) -> np.ndarray:
    """Unsigned distance of (N, 3) points to the room's analytic surfaces."""
    d_floor = np.abs(pts[:, 2] - scene["floor_z"])
    d_wall = np.abs(pts[:, 1] - scene["wall_y"])
    lo, hi = scene["box_lo"], scene["box_hi"]
    q = np.maximum(lo[None] - pts, pts - hi[None])
    d_box = np.abs(np.linalg.norm(np.maximum(q, 0.0), axis=1)
                   + np.minimum(q.max(axis=1), 0.0))
    return np.minimum(np.minimum(d_floor, d_wall), d_box)


def phase_served(card: str, n_agents: int = 4, n_kf: int = 24,
                 width: int = 640, height: int = 480, pcfg=None) -> dict:
    import jax

    from cvids_tpu.camera import PinholeCamera
    from cvids_tpu.io import multiagent, render
    from cvids_tpu.mapping.mesh import read_ply
    from cvids_tpu.server import pipeline, vocab
    from cvids_tpu.utils.metrics import ate_rmse, umeyama

    s = width / 640.0
    k = (np.diag([s, s, 1.0]) @ K640).astype(np.float32)
    cam = PinholeCamera.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2],
                               (0, 0, 0, 0), width, height)
    t0 = time.time()
    packets, gt, descs = multiagent.rendered_orbit_stream(
        cam, n_agents, n_kf, seed=SEED)
    voc = vocab.train_vocabulary(descs, k=8, levels=2, seed=SEED)
    print(f"[served] rendered {len(packets)} keyframes of {width}x{height} "
          f"for {n_agents} agents in {time.time() - t0:.1f}s", flush=True)

    server = pipeline.CollaborativeServer(voc, pcfg or pipeline.PipelineConfig())
    for cid in range(n_agents):
        server.set_client_intrinsics(cid, k)
    t0 = time.time()
    for p in packets:
        server.submit(p)
    server.process()
    server.optimize()
    proc_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        n_verts = server.save_mesh(os.path.join(tmp, "mesh.ply"))
        verts = (read_ply(os.path.join(tmp, "mesh.ply"))[0]
                 if n_verts else np.zeros((0, 3)))
    g = server.graph
    aligned = [g.clients[c].aligned for c in range(n_agents)]
    per_client = {c: sum(r["client"] == c for r in server.depth_records)
                  for c in range(n_agents)}
    est, ref = [], []
    for c in range(n_agents):
        tr = server.trajectory(c)
        est.append(tr[:, 1:4])
        ref.append(np.stack([gt[(c, i)][0] for i in range(len(tr))]))
    est, ref = np.concatenate(est), np.concatenate(ref)
    ate = ate_rmse(est, ref, "sim3")
    _, r_al, t_al = umeyama(est, ref)
    scene = render.default_scene()
    d_mesh = (float(np.median(_scene_distance(
        np.asarray(verts, np.float64).reshape(-1, 3) @ r_al.T + t_al, scene)))
        if n_verts else float("inf"))
    voxel = server.cfg.tsdf.voxel_size
    print(f"[served] aligned {aligned}, loops {g.loop_count}, depth maps per "
          f"client {per_client}, TSDF chunks {len(server.volume.slot_of)}, "
          f"mesh {n_verts} vertices, median scene distance {d_mesh:.4f} m, "
          f"sim3 ATE {ate * 100:.3f} cm over {len(est)} keyframes", flush=True)
    kfs = len(packets) / proc_s
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[served] {kfs:.2f} keyframes/s through process()+optimize() "
          f"({proc_s:.1f}s incl. compilation; card {card}); peak device "
          f"bytes {stats.get('peak_bytes_in_use')}", flush=True)
    print("[served] tracer totals:\n" + server.tracer.report(), flush=True)
    _check(all(aligned), f"all {n_agents} clients aligned")
    _check(min(per_client.values()) >= 1, ">= 1 published depth map per client")
    _check(len(server.volume.slot_of) > 100, "TSDF allocated > 100 chunks")
    _check(n_verts > 0, "save_mesh wrote a non-empty mesh")
    _check(d_mesh < 2 * voxel, f"mesh median scene distance < {2 * voxel:.2f} m")
    _check(ate < 0.10, "sim3 ATE of every keyframe < 10 cm")
    return {"keyframes_per_s": kfs, "ate_m": ate, "mesh_dist_m": d_mesh}


# ---------------------------------------------------------------------------
# phase 4: agent window BA, GPU vs the CPU device
# ---------------------------------------------------------------------------

def phase_window_ba(card: str) -> dict:
    import jax

    from cvids_tpu.io.synthetic import window_ba_problem
    from cvids_tpu.utils.precision import full_precision
    from cvids_tpu.vio import window_ba as ba

    state, meas = window_ba_problem()
    solve = full_precision(jax.jit(
        lambda s, m: ba.solve_window_schur(s, m, iters=10)))
    _, cost = solve(state, meas)
    cpu = jax.devices("cpu")[0]
    _, cost_cpu = solve(jax.device_put(state, cpu), jax.device_put(meas, cpu))
    cost, cost_cpu = float(cost), float(cost_cpu)
    rel = abs(cost - cost_cpu) / max(abs(cost_cpu), 1e-12)
    ms = _median_ms(solve, state, meas, n=5)
    print(f"[window BA] 20 KF / 150 landmarks, 10 LM iters: final cost "
          f"{cost:.6g} on {jax.devices()[0].device_kind}, {cost_cpu:.6g} on "
          f"the CPU device (rel. diff {rel:.3g}, tolerance 1e-2); "
          f"{ms:.3f} ms per solve (card {card})", flush=True)
    _check(rel < 1e-2, "window BA final cost within 1 % of the CPU solve")
    return {"window_ba_ms": ms}


# ---------------------------------------------------------------------------
# --four-cards: the sharded production programs, 4-card mesh vs one card
# ---------------------------------------------------------------------------

def phase_four_cards(card: str, n: int = 4, small: bool = False) -> dict:
    import __graft_entry__ as ge
    from cvids_tpu.parallel import make_mesh

    mesh_n = make_mesh(n)
    t0 = time.time()
    res_n = ge.production_phases(mesh_n, small=small)
    t_n = time.time() - t0
    t0 = time.time()
    res_1 = ge.production_phases(make_mesh(1), n_agents=n, small=small)
    t_1 = time.time() - t0
    print(f"[four cards] mesh {mesh_n.devices.shape} over "
          f"{[d.device_kind for d in mesh_n.devices.flat]} ({card})", flush=True)
    for line in res_n["audits"]:
        print(f"  audit: {line}", flush=True)
    res = ge.compare_phases(res_n, res_1)
    for key, (a, b, tol) in res.items():
        print(f"  {key}: {n} cards vs 1 card: {a} (tolerance {tol})", flush=True)
    print(f"[four cards] wall (incl. compilation): {n} cards {t_n:.1f}s, "
          f"1 card {t_1:.1f}s (card {card})", flush=True)
    for key, (_, b, _) in res.items():
        _check(b, f"{key}: {n}-card result matches 1-card result")
    return {"cards": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase and its "
                         "1-card comparison")
    args = ap.parse_args(argv)

    import jax

    from cvids_tpu.utils.device import (card_info, configure_compile_cache,
                                        require_gpu)

    devs = require_gpu()
    card = card_info()
    cache = configure_compile_cache(REPO)
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    print(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
          f"card {card}; compile cache {cache}", flush=True)

    t_start = time.time()
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_kernels(card)
        phase_served(card)
        phase_window_ba(card)
    print(f"[done] {time.time() - t_start:.1f}s; card {card}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
