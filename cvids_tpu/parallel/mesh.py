"""Device-mesh helpers and sharded execution wrappers.

The reference scales by OS processes + ROS (`launch/multi_agent_server.launch`,
4 agent nodes + server + chisel); here scale-out is a `jax.sharding.Mesh`:

- the **agent axis** shards per-agent work (dense depth fusion, front-end
  batches) like the reference's agent-level process parallelism;
- the **edge/node axes** of the pose-graph solver shard the global 4-DoF
  optimization: the CG matvec's segment-sums become `psum`-style collectives
  that XLA inserts automatically from sharding annotations.

Everything works on any device set — several GPUs of one host, whose NVLink
joins every card to every other so a 1-D mesh over all of them fits, or N
virtual CPU devices (`--xla_force_host_platform_device_count`) for testing.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..server import optimizer as opt

__all__ = ["make_mesh", "shard_posegraph_solve", "sharded_dense_fuse"]


def make_mesh(n_devices: int | None = None, axis: str = "agents") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_posegraph_solve(mesh: Mesh, lm_iters: int = 10, cg_iters: int = 40):
    """Jitted 4-DoF solve with edges sharded across the mesh.

    Nodes are replicated (they're small: 4 floats per keyframe); the edge
    arrays — the big axis — are sharded, so residual/Jacobian evaluation is
    embarrassingly parallel and the segment-sum gather/scatter in the CG
    matvec reduces across devices (XLA inserts the all-reduces).
    """
    axis = mesh.axis_names[0]
    repl = NamedSharding(mesh, P())
    edge_shard = NamedSharding(mesh, P(axis))

    nodes_s = opt.PoseGraphNodes(*([repl] * 5))
    edges_s = opt.PoseGraphEdges(*([edge_shard] * 8))

    return jax.jit(
        partial(opt.optimize_pose_graph, lm_iters=lm_iters, cg_iters=cg_iters),
        in_shardings=(nodes_s, edges_s),
        out_shardings=nodes_s)


def sharded_dense_fuse(mesh: Mesh, cfg):
    """Batched dense-depth fusion with the agent axis sharded over devices.

    Maps `dense.estimator.fuse_measurement` over a leading agent dimension
    (a multiple of the mesh size) and shards it: inside `shard_map` each
    device fuses its own agents' frames, so no collective runs and the SGM
    kernel sees only device-local data (the reference's one-GPU-per-agent
    pattern). Every input and output is sharded on the agent axis.
    """
    from ..dense import estimator

    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis))
    vfuse = jax.vmap(lambda st, img, a, b: estimator.fuse_measurement(
        cfg, st, img, a, b))
    # check_vma=False: the SGM kernel's pallas_call declares no per-axis
    # variance for its outputs
    fn = jax.shard_map(vfuse, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
                       check_vma=False)
    return jax.jit(fn, in_shardings=shard, out_shardings=shard)


def pad_edges_for_sharding(edges: opt.PoseGraphEdges, n_shards: int):
    """Pad the edge axis to a multiple of the mesh size (invalid padding)."""
    import jax.numpy as jnp
    e = edges.i.shape[0]
    pad = (-e) % n_shards
    if pad == 0:
        return edges
    def pz(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)
    return opt.PoseGraphEdges(
        i=pz(edges.i), j=pz(edges.j), t_ij=pz(edges.t_ij),
        yaw_ij=pz(edges.yaw_ij), t_weight=pz(edges.t_weight),
        yaw_weight=pz(edges.yaw_weight), valid=pz(edges.valid),
        huber=pz(edges.huber))
