"""--report machinery: completeness, resume, incremental index.html.

Each combination renders via a CLI subprocess (report.py); at 32^2 with
-i 1 the whole 28-combo matrix is cheap enough for CI. Here we check the
report state machine around it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow


def _run_report(cwd, extra=()):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo)
    return subprocess.run(
        [sys.executable, "-m", "smallvcm_tpu.cli", "--report", "-i", "1",
         "--resolution", "32", "32", *extra],
        cwd=str(cwd), env=env, capture_output=True, text=True,
    )


def test_report_complete_and_resumes(tmp_path):
    proc = _run_report(tmp_path)
    assert proc.returncode == 0, proc.stderr[-800:]

    bmps = sorted(p.name for p in tmp_path.glob("*.bmp"))
    assert len(bmps) == 28, bmps
    index = (tmp_path / "index.html").read_text()
    assert all(b in index for b in bmps)

    state = json.loads((tmp_path / "report_state.json").read_text())
    assert len(state) == 28
    assert all(r["iters"] == 1 for r in state.values())

    # Resume: delete one BMP; a re-run renders ONLY that combo (every
    # other is skipped via the state sidecar, so the rerun is fast).
    victim = bmps[5]
    (tmp_path / victim).unlink()
    mtimes = {b: (tmp_path / b).stat().st_mtime_ns
              for b in bmps if b != victim}
    proc = _run_report(tmp_path)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert (tmp_path / victim).exists()
    for b, t in mtimes.items():
        assert (tmp_path / b).stat().st_mtime_ns == t, f"{b} re-rendered"
    assert proc.stdout.count("already done") == 27
