#!/usr/bin/env python
"""Weak-scaling sweep of the sharded solvers on a virtual CPU mesh.

Fixed per-device work; ideal weak scaling keeps wall time constant as
devices double. NOTE the honest caveat: this box has 2 physical cores, so
only the 1->2 step can show real parallel speed; 4/8 virtual devices
time-share cores and measure partitioning overhead, not scaling. What the
sweep DOES establish on any device count:
  - the SPMD programs compile + run at every mesh size,
  - results are device-count invariant (equivalence),
  - the compiled HLO contains the expected cross-device collectives
    (all-reduce), i.e. the program really is distributed, and the same
    code targets several GPUs unchanged.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     PYTHONPATH= python dev/bench_scaling.py
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cvids_tpu.parallel import mesh as pmesh
from cvids_tpu.server import optimizer as opt


def make_problem(rng, n_nodes, n_edges):
    yaw = rng.uniform(-1, 1, n_nodes).astype(np.float32)
    t = rng.uniform(-5, 5, (n_nodes, 3)).astype(np.float32)
    nodes = opt.PoseGraphNodes(
        yaw=jnp.asarray(yaw), pr=jnp.zeros((n_nodes, 2)),
        t=jnp.asarray(t),
        valid=jnp.ones(n_nodes, bool),
        fixed=jnp.zeros(n_nodes, bool).at[0].set(True))
    i = rng.integers(0, n_nodes - 1, n_edges).astype(np.int32)
    j = np.minimum(i + rng.integers(1, 8, n_edges), n_nodes - 1).astype(np.int32)
    edges = opt.PoseGraphEdges(
        i=jnp.asarray(i), j=jnp.asarray(j),
        t_ij=jnp.asarray(rng.normal(size=(n_edges, 3)).astype(np.float32)),
        yaw_ij=jnp.asarray(rng.normal(size=n_edges).astype(np.float32) * 0.1),
        t_weight=jnp.ones(n_edges), yaw_weight=jnp.ones(n_edges),
        valid=jnp.ones(n_edges, bool), huber=jnp.full(n_edges, jnp.inf))
    return nodes, edges


def main():
    rng = np.random.default_rng(0)
    edges_per_dev = 4096
    nodes_base = 512
    print(f"devices available: {len(jax.devices())}, "
          f"physical cores: {os.cpu_count()}")
    results = {}
    for n in (1, 2, 4, 8):
        m = pmesh.make_mesh(n, axis="edges")
        solve = pmesh.shard_posegraph_solve(m, lm_iters=6, cg_iters=30)
        nodes, edges = make_problem(rng, nodes_base * n, edges_per_dev * n)
        out = solve(nodes, edges)         # compile + run
        jax.block_until_ready(out)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = solve(nodes, edges)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        results[n] = dt
        # collectives in the compiled module?
        txt = solve.lower(nodes, edges).compile().as_text()
        n_ar = txt.count("all-reduce")
        print(f"n={n}: {dt * 1e3:8.1f} ms/solve  ({edges_per_dev}/dev edges)"
              f"  all-reduce ops in HLO: {n_ar}")
    base = results[1]
    for n, dt in results.items():
        print(f"weak-scaling efficiency {n} dev: {base / dt:.2f}"
              f"{'  (core-limited beyond 2)' if n > 2 else ''}")


if __name__ == "__main__":
    main()
