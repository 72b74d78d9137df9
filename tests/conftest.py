"""Test configuration: force an 8-virtual-device CPU backend.

The tests are CPU tests: they check results at small sizes, and the
multi-device sharding paths run on a virtual CPU mesh; the same
`Mesh`/`NamedSharding` code runs unchanged on several GPUs. Tests that need
the card carry the `gpu` marker and run their payload in a child process
with the platform left at its default (`tests/test_gpu.py`).
"""

import os

# Force CPU even on a machine with a GPU: one JAX process per card, and the
# test process must not reserve the card's memory. Set both the variable and
# the config, in case JAX was imported before this file.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The XLA CPU thunk runtime JIT-allocates ~3 memory maps per compiled
# kernel, and compiled executables stay cached for the life of the process;
# a full slow-suite run accumulates >65530 maps (the default
# vm.max_map_count), after which mmap fails and the NEXT compile aborts the
# interpreter (observed: `pytest -m slow` dying in test_frontend's first
# window-BA compile with `Fatal Python error: Aborted`, one thread, no
# message — while every test passes in isolation). Two defenses:
# raise the limit when we can, and drop executable caches between tests.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 262144:
            with open("/proc/sys/vm/max_map_count", "w") as _f:
                _f.write("262144")
            # a system-wide, persistent sysctl change deserves a visible
            # notice, not a silent side effect of collecting tests
            import warnings as _warnings
            _warnings.warn("conftest raised vm.max_map_count to 262144 "
                           "(system-wide, persists until reboot) to keep "
                           "the slow suite's XLA JIT maps under the limit",
                           stacklevel=1)
except (OSError, PermissionError, ValueError):
    pass  # not root / not Linux: the per-test cache clear still bounds usage


@pytest.fixture(autouse=True)
def _clear_jax_caches_after_heavy_tests(request):
    yield
    # only slow tests compile enough to matter; clearing after every fast
    # test would force pointless recompiles of shared small programs
    if request.node.get_closest_marker("slow") is not None:
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
