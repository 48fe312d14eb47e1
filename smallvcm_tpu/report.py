"""--report mode: all 4 scenes x 7 algorithms -> BMPs + index.html.

Mirrors FullReport (smallvcm.cxx:156-263): renders every combination,
saves gamma-2.2 BMPs with the reference's default filenames, emits the
thumbnail matrix with the good/poor border colors and the 4-way
PPM/BPM/BPT/VCM split per scene.

Every combination renders in its own subprocess through the CLI, so the
report process itself never holds the device. Results
(elapsed/iterations) persist in ``report_state.json`` and ``index.html``
is rewritten after every combination, so a killed run resumes where it
left off and always leaves a viewable report behind. A combination that
fails is reported and left for a re-run; nothing is retried with other
settings.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from .io.html import GOOD_ALGORITHMS, GREEN, NONE, POOR_ALGORITHMS, RED, HtmlWriter
from .render import ALGORITHM_NAMES, ALGORITHMS
from .scene.scene import SCENE_CONFIGS, get_scene_name

_DONE_RE = re.compile(r"done in ([0-9.]+) s \((\d+) iterations?\)")

STATE_FILE = "report_state.json"


def _render_combo(scene_id: int, alg: str, filename: str, args):
    """Render one (scene, algorithm) via the CLI in a subprocess.

    Returns (elapsed_seconds, iterations); raises RuntimeError on failure.
    """
    # The report typically runs with cwd set to the OUTPUT directory;
    # make the package importable in the child regardless.
    env = dict(os.environ)
    pkg_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = (
        pkg_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH") else pkg_root
    )
    cmd = [
        sys.executable, "-m", "smallvcm_tpu.cli",
        "-s", str(scene_id), "-a", alg, "-o", filename,
        "--resolution", str(args.resolution[0]), str(args.resolution[1]),
        "--seed", str(args.seed),
        "--max-path-length", str(args.max_path_length),
        "--min-path-length", str(args.min_path_length),
        "--radius-factor", str(args.radius_factor),
        "--radius-alpha", str(args.radius_alpha),
    ]
    if args.max_time > 0:
        cmd += ["-t", str(args.max_time)]
    else:
        cmd += ["-i", str(args.iterations)]

    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    m = _DONE_RE.search(proc.stdout or "")
    if proc.returncode == 0 and m and os.path.exists(filename):
        return float(m.group(1)), int(m.group(2))
    raise RuntimeError(
        f"report combo scene {scene_id} alg {alg} failed "
        f"(rc={proc.returncode}): {(proc.stderr or '').strip()[-400:]}"
    )


def _effective_settings(args) -> dict:
    """The render settings a completed combo must have been produced
    with for resume to skip it. Stored in every state record; a --report
    re-run with different -i/-t/--resolution/--seed/path-length/radius
    args re-renders instead of silently reusing stale images."""
    return {
        "resolution": list(args.resolution),
        "seed": args.seed,
        "iterations": args.iterations,
        "max_time": args.max_time,
        "max_path_length": args.max_path_length,
        "min_path_length": args.min_path_length,
        "radius_factor": args.radius_factor,
        "radius_alpha": args.radius_alpha,
    }


def _load_state() -> dict:
    try:
        return json.loads(Path(STATE_FILE).read_text())
    except (OSError, ValueError):
        return {}


def _save_state(state: dict) -> None:
    Path(STATE_FILE).write_text(json.dumps(state, indent=1))


def _write_html(results: dict, args) -> None:
    """(Re)build index.html from every completed combination so far."""
    from .cli import build_default_filename

    html = HtmlWriter("index.html")
    split_acronyms = ["PPM", "BPM", "BPT", "VCM"]
    resolution = tuple(args.resolution)

    for scene_id, scene_config in enumerate(SCENE_CONFIGS):
        scene_name, _ = get_scene_name(scene_config)
        html.add_scene(scene_name)
        split_files = ["", "", "", ""]
        split_borders = [NONE] * 4
        for alg in ALGORITHMS:
            filename = build_default_filename(scene_config, alg)
            rec = results.get(filename)
            if rec is None:
                continue
            border = NONE
            if alg in POOR_ALGORITHMS[scene_id]:
                border = RED
            if alg in GOOD_ALGORITHMS[scene_id]:
                border = GREEN
            html.add_rendering(
                ALGORITHM_NAMES[alg], filename, rec["elapsed"], border,
                f"<br/>Iterations: {rec['iters']}",
            )
            if alg in ("ppm", "bpm", "bpt", "vcm"):
                idx = ("ppm", "bpm", "bpt", "vcm").index(alg)
                split_files[idx] = filename
                split_borders[idx] = border
        html.add_four_way_split(
            split_files, split_acronyms, split_borders, resolution[0]
        )
    html.close()


def full_report(args) -> None:
    from .cli import build_default_filename

    state = _load_state()
    start = time.time()
    failed = []
    for scene_id, scene_config in enumerate(SCENE_CONFIGS):
        scene_name, _ = get_scene_name(scene_config)
        print(f"Scene: {scene_name}")
        for alg in ALGORITHMS:
            filename = build_default_filename(scene_config, alg)
            settings = _effective_settings(args)
            if (filename in state and os.path.exists(filename)
                    and state[filename].get("settings") == settings):
                print(f"Running {ALGORITHM_NAMES[alg]}... "
                      f"already done ({state[filename]['elapsed']:.2f} s)",
                      flush=True)
                continue
            print(f"Running {ALGORITHM_NAMES[alg]}... ", end="", flush=True)
            try:
                elapsed, iters = _render_combo(scene_id, alg, filename, args)
            except RuntimeError as e:
                # Keep going: every other combo still renders, the HTML
                # stays viewable, and a re-run renders ONLY the failures.
                print(f"FAILED ({e})", flush=True)
                failed.append(filename)
                continue
            print(f"done in {elapsed:.2f} s")
            state[filename] = {"elapsed": elapsed, "iters": iters,
                               "scene": scene_id, "alg": alg,
                               "settings": settings}
            _save_state(state)
            _write_html(state, args)

    _write_html(state, args)
    print(f"Whole run took {time.time() - start:.2f} s")
    if failed:
        print(f"INCOMPLETE: {len(failed)} combination(s) failed "
              f"({', '.join(failed)}); re-run --report to retry them.")
        raise SystemExit(1)
