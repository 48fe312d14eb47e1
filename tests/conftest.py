"""Test configuration: a virtual 8-device CPU mesh unless told otherwise.

Numerics tests and the sharded tests run on the CPU; multi-device sharding
is validated on a host-platform virtual mesh. ``JAX_PLATFORMS`` pins the
CPU only when it is unset, so ``JAX_PLATFORMS=cuda,cpu`` runs the suite on
a GPU host (the ``gpu``-marked tests need that; they skip elsewhere).
Must run before jax initializes a backend.
"""

import os
import subprocess
import tempfile
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Merge-cap sizing sidecar: keep tests away from the user's cache (and
# from each other's stale entries — the key spans alg/res/radius).
os.environ["SMALLVCM_TPU_CACHE"] = os.path.join(
    tempfile.gettempdir(), "smallvcm_test_caps")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

REFERENCE_SRC = Path("/root/reference/src/smallvcm.cxx")
REFERENCE_BIN = Path("/tmp/refbin/smallvcm")


@pytest.fixture(scope="session")
def reference_binary():
    """Compile the reference renderer (the test oracle) once per session."""
    if not REFERENCE_BIN.exists():
        if not REFERENCE_SRC.exists():
            pytest.skip("reference source not available")
        REFERENCE_BIN.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++", "-O3", "-std=c++11", "-fopenmp",
                "-o", str(REFERENCE_BIN), str(REFERENCE_SRC),
            ],
            check=True,
        )
    return REFERENCE_BIN


def run_reference(reference_bin, workdir, *args):
    """Run the reference renderer in workdir; returns stdout."""
    out = subprocess.run(
        [str(reference_bin), *args],
        cwd=str(workdir),
        check=True,
        capture_output=True,
        text=True,
    )
    return out.stdout


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu)")
