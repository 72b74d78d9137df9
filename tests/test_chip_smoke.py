"""`chip_smoke.py` refuses to run without a GPU, and the compile-cache rule
it shares with `bench.py`."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from cvids_tpu.utils.device import compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_refuses_cpu_only_run():
    res = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert not _printed_result(res.stdout)


@pytest.mark.parametrize("env_dir", [None, "/var/cache/jax-elsewhere"])
def test_compile_cache_dir_rule(tmp_path, env_dir):
    environ = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    got = compile_cache_dir(str(tmp_path), environ)
    if env_dir is None:
        assert got == os.path.join(str(tmp_path), ".jax_cache")
    else:
        assert got is None   # JAX reads the variable itself; nothing is set
