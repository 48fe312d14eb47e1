"""Device and cache rules of the entry points, checked on the CPU.

chip_smoke.py and bench.py must refuse to report anything without a GPU,
and the package's compile-cache rule must hold with JAX_COMPILATION_CACHE_DIR
set and unset. Each case runs a fresh interpreter, since both rules act
when JAX starts.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, drop=(), cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_exits_nonzero_without_result(script):
    proc = _run([str(REPO / script)])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "rays/s" not in proc.stdout
    assert "no GPU" in proc.stderr


_PRINT_CACHE = ("import jax, smallvcm_tpu; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_defaults_to_checkout():
    proc = _run(["-c", _PRINT_CACHE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(REPO / ".jax_cache")


def test_compile_cache_env_wins(tmp_path):
    want = str(tmp_path / "cache")
    proc = _run(["-c", _PRINT_CACHE],
                env_extra={"JAX_COMPILATION_CACHE_DIR": want})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == want
