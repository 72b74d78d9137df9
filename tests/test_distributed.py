"""Two-process jax.distributed smoke test (CPU backend).

Exercises the true multi-HOST path — separate OS processes, a coordinator,
and cross-process collectives — that the virtual 8-device mesh cannot: on a
multi-host GPU cluster each host runs exactly this initialization with its
local cards.
Skips (not fails) when the installed jax lacks a CPU cross-process
collectives backend.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    pid = int(sys.argv[1]); port = sys.argv[2]
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    devs = np.asarray(jax.devices())          # 4 global (2 per process)
    assert devs.size == 4, devs
    mesh = Mesh(devs, ("d",))

    def f(x):
        return jax.lax.psum(x, "d")

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=P("d"), out_specs=P("d")))
    x = jnp.arange(8.0).reshape(4, 2)
    from jax.sharding import NamedSharding
    xs = jax.device_put(x, NamedSharding(mesh, P("d")))
    out = g(xs)
    # psum over the device axis: every shard row = column sums of x
    expect = x.sum(axis=0)
    got = np.asarray(out.addressable_shards[0].data)
    np.testing.assert_allclose(got, np.tile(expect, (got.shape[0], 1)))
    print(f"proc {pid} OK", flush=True)
""")


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    joined = "\n---\n".join(o for _, o in outs)
    if any(rc != 0 for rc, _ in outs):
        low = joined.lower()
        if ("collectives" in low or "gloo" in low or "not implemented" in low
                or "unimplemented" in low or "cross host" in low):
            pytest.skip(f"no CPU cross-process collectives backend:\n{joined[-800:]}")
        raise AssertionError(joined[-2000:])
    assert "proc 0 OK" in joined and "proc 1 OK" in joined
