"""Production-shape dense step on a CUDA GPU.

The test process is held to the CPU (`conftest.py`), so the payload runs in
a child process with the platform left at its default. Whether a card is
present is decided inside the test: first `nvidia-smi -L`, then the child.
Without a card the test skips. Run it on the card with
`python -m pytest tests/test_gpu.py -m gpu`.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.gpu

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PAYLOAD = r"""
import numpy as np, jax, jax.numpy as jnp
from cvids_tpu.dense import estimator
from cvids_tpu.ops import sgm
assert jax.devices()[0].platform == "gpu", jax.devices()
cfg = estimator.DenseConfig()   # 480 x 640 x 128
rng = np.random.default_rng(0)
ref = jnp.asarray(rng.uniform(0, 255, (cfg.height, cfg.width)), jnp.float32)
meas = jnp.asarray(rng.uniform(0, 255, (cfg.height, cfg.width)), jnp.float32)
k = jnp.asarray([[461.0, 0, 320], [0, 461.0, 240], [0, 0, 1]], jnp.float32)
st = estimator.init_reference(cfg, ref)
st = estimator.fuse_measurement(cfg, st, meas, k @ jnp.linalg.inv(k),
                                k @ jnp.asarray([-0.11, 0.0, 0.0]))
assert np.isfinite(np.asarray(st.filt.mu)).all()
cost = jnp.asarray(rng.uniform(0, 50, (cfg.height, cfg.width, cfg.num_depths)),
                   jnp.float32)
p2 = jnp.full((cfg.height, cfg.width), 64.0, jnp.float32)
for axis in (0, 1):
    got = sgm.scan_pair(cost, p2, jnp.float32(16.0), axis)
    want = sgm.scan_pair_plain(cost, p2, jnp.float32(16.0), axis)
    assert float(jnp.max(jnp.abs(got - want))) < 1e-3 * float(jnp.max(want))
print("GPU_OK")
"""


def test_dense_step_production_shape_on_gpu():
    try:
        listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("nvidia-smi not found: no CUDA GPU on this machine")
    if listed.returncode != 0 or "GPU" not in listed.stdout:
        pytest.skip("nvidia-smi lists no GPU")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, "-c", _PAYLOAD], env=env,
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "GPU_OK" in res.stdout
