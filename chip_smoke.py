"""Prove the renderer's main path on one GPU; with --four, the sharded path
on four.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: only the sharded phase

One card, everything in this one process (a second JAX process would find
the card's memory taken):

1. the card's name and power limit, read by ``nvidia-smi`` in a child
   process that stays off JAX;
2. all seven algorithms on scene 0 at 512x512 through ``render()`` with
   default settings, each image mean checked against the reference
   binary's mean in PARITY.md ("mean (ref)"), with steady ms/iter, the
   first block's seconds (compile + cap sizing + one block) and the
   device's peak bytes in use;
3. GPU against CPU at 64x64 for pt, bpt and vcm, same seed, in this
   process through ``jax.devices("cpu")``;
4. one CLI render through ``cli.main`` (in-process);
5. whether two identical 512x512 vcm renders are bitwise equal.

Four cards (``--four``): vcm at 1024x1024 on ``make_mesh(4)`` against one
card, same seed and iteration, with ms/iter and each card's peak bytes.

Any failed phase makes the exit code non-zero. Without a GPU the script
exits non-zero before doing anything. The last line of a passing run is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

# PARITY.md "mean (ref)", scene 0: the compiled reference binary, 512x512,
# 32 iterations.
REF_MEANS_SCENE0 = {
    "el": 0.52085, "pt": 0.08275, "lt": 0.08488, "ppm": 0.10747,
    "bpm": 0.10769, "bpt": 0.10308, "vcm": 0.10758,
}
# el is deterministic up to its per-iteration pixel jitter, so its mean
# matches to ~1e-5; the six Monte-Carlo estimators differ from the
# reference by their own noise (independent RNG streams): at 512x512 and
# 8-64 iterations the image-mean noise is well under 1%, so 2% catches a
# biased estimator without flagging noise.
MEAN_RTOL = {"el": 0.002}
MEAN_RTOL_STOCHASTIC = 0.02
RES = 512
FOUR_RES = 1024
# Iterations per algorithm: two full blocks, so the second block is steady
# state (auto block: 64 for el/pt, 8 for the others at 512x512).
ITERS_512 = {"el": 128, "pt": 128, "lt": 16, "ppm": 16, "bpm": 16,
             "bpt": 16, "vcm": 16}
# Sharded vs one card, per pixel (same bound as tests/test_sharding.py):
# psum and the per-shard scatters add in another order.
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def require_gpu():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {devs[0].platform!r} "
              "devices only", file=sys.stderr)
        sys.exit(2)
    return devs


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def timed_render(scene, cfg):
    """render() with a timestamp at every block (each block ends in a host
    sync). Returns (image, first_block_s, steady_ms_per_iter)."""
    from smallvcm_tpu.render import render

    marks = []
    t0 = time.perf_counter()
    img, _, done = render(
        scene, cfg,
        block_cb=lambda acc, d: marks.append((time.perf_counter(), d)),
    )
    img.block_until_ready()
    first_s = marks[0][0] - t0
    (ta, da), (tb, db) = marks[0], marks[-1]
    steady = (tb - ta) / (db - da) * 1e3 if db > da else float("nan")
    return img, first_s, steady


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        print(f"--- {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, fail at the end
            traceback.print_exc()
            self.failed.append(name)
            print(f"FAIL {name}", flush=True)
        else:
            print(f"ok {name} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


def phase_algorithms(dev, state):
    import numpy as np

    from smallvcm_tpu.render import ALGORITHMS, RenderConfig, auto_block_size
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0])
    state["scene512"] = scene
    bad = []
    for alg in ALGORITHMS:
        cfg = RenderConfig(algorithm=alg, iterations=ITERS_512[alg],
                           resolution=(RES, RES))
        img, first_s, steady = timed_render(scene, cfg)
        img = np.asarray(img)
        mean = float(img.mean())
        ref = REF_MEANS_SCENE0[alg]
        rel = abs(mean - ref) / ref
        tol = MEAN_RTOL.get(alg, MEAN_RTOL_STOCHASTIC)
        ok = bool(np.isfinite(img).all()) and img.shape == (RES, RES, 3) \
            and rel <= tol
        print(f"{alg}: iters={ITERS_512[alg]} "
              f"block={auto_block_size(cfg, alg)} "
              f"mean={mean:.6f} ref={ref:.5f} rel={rel:.5f} tol={tol} "
              f"steady_ms_per_iter={steady:.3f} "
              f"first_block_s={first_s:.2f} "
              f"peak_bytes_in_use={peak_bytes(dev)} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            bad.append(alg)
    if bad:
        raise AssertionError(f"image mean out of tolerance: {bad}")


def phase_gpu_vs_cpu():
    import jax
    import numpy as np

    from smallvcm_tpu.render import RenderConfig, render
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    res = (64, 64)
    cpu = jax.devices("cpu")[0]
    bad = []
    for alg in ("pt", "bpt", "vcm"):
        scene = load_cornell_box(res, SCENE_CONFIGS[0])
        g, _, _ = render(scene, RenderConfig(algorithm=alg, resolution=res))
        g = np.asarray(g)
        with jax.default_device(cpu):
            scene_c = load_cornell_box(res, SCENE_CONFIGS[0])
            c, _, _ = render(scene_c, RenderConfig(algorithm=alg,
                                                   resolution=res))
            c = np.asarray(c)
        diff = np.abs(g - c)
        close = diff <= 1e-4 + 1e-4 * np.abs(c)
        mean_rel = abs(g.mean() - c.mean()) / c.mean()
        print(f"{alg} 64^2 gpu vs cpu: max|diff|={diff.max():.3e} "
              f"pixels within 1e-4={close.mean():.5f} "
              f"mean rel diff={mean_rel:.3e} bitwise_equal="
              f"{bool((g == c).all())}", flush=True)
        if close.mean() < 0.99 or mean_rel > 1e-3:
            bad.append(alg)
    if bad:
        raise AssertionError(f"GPU and CPU disagree: {bad}")


def phase_cli():
    import numpy as np

    from smallvcm_tpu import cli
    from smallvcm_tpu.io.framebuffer import load_bmp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "smoke_vcm.bmp")
        rc = cli.main(["-s", "0", "-a", "vcm", "-i", "8", "-o", out,
                       "--devices", "1", "--resolution", str(RES), str(RES)])
        assert rc == 0, rc
        size = os.path.getsize(out)
        assert size == 54 + RES * RES * 3, size
        img = load_bmp(out)
        assert img.shape == (RES, RES, 3) and np.asarray(img).mean() > 0


def phase_determinism(state):
    import numpy as np

    from smallvcm_tpu.render import RenderConfig, render

    scene = state["scene512"]
    cfg = dict(algorithm="vcm", iterations=8, resolution=(RES, RES))
    a, _, _ = render(scene, RenderConfig(**cfg))
    b, _, _ = render(scene, RenderConfig(**cfg))
    a, b = np.asarray(a), np.asarray(b)
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(a), 1e-12)
    print(f"vcm 512^2 x8 twice: bitwise_equal={bool((a == b).all())} "
          f"differing pixels={float((a != b).mean()):.6f} "
          f"max|diff|={diff.max():.3e} max rel diff={rel.max():.3e} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)


def phase_four(devs):
    import jax
    import numpy as np

    from smallvcm_tpu.parallel.sharding import make_mesh
    from smallvcm_tpu.render import RenderConfig, render
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    assert len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}"
    res = (FOUR_RES, FOUR_RES)
    scene = load_cornell_box(res, SCENE_CONFIGS[0])
    one_cfg = RenderConfig(algorithm="vcm", iterations=1, resolution=res)
    t0 = time.perf_counter()
    one, _, _ = render(scene, one_cfg)
    one = np.asarray(one)
    print(f"one card: vcm {FOUR_RES}^2 iteration 0 in "
          f"{time.perf_counter() - t0:.1f} s (incl. compile)", flush=True)

    mesh = make_mesh(4)
    # Start the shards from the one-card caps with slack for the uneven
    # split of merge work over the shards' image rows; an overflow would
    # still grow them and re-render the block.
    four_cfg = RenderConfig(
        algorithm="vcm", iterations=1, resolution=res, mesh=mesh,
        pair_factor=one_cfg.pair_factor * 1.5,
        photon_factor=one_cfg.photon_factor,
        query_factor=one_cfg.query_factor * 1.5,
    )
    t0 = time.perf_counter()
    four, _, _ = render(scene, four_cfg)
    four = np.asarray(four)
    print(f"four cards: vcm {FOUR_RES}^2 iteration 0 in "
          f"{time.perf_counter() - t0:.1f} s (incl. compile)", flush=True)
    diff = np.abs(four - one)
    print(f"four vs one card: max|diff|={diff.max():.3e} "
          f"max rel={float((diff / np.maximum(one, 1e-12)).max()):.3e} "
          f"mean one={one.mean():.6f} four={four.mean():.6f}", flush=True)
    np.testing.assert_allclose(four, one, rtol=SHARD_RTOL, atol=SHARD_ATOL)

    one_cfg.iterations = 4
    _, _, one_steady = timed_render(scene, one_cfg)
    print(f"one card: vcm {FOUR_RES}^2 steady_ms_per_iter={one_steady:.3f}",
          flush=True)
    four_cfg.iterations = 4
    _, first_s, steady = timed_render(scene, four_cfg)
    print(f"four cards: vcm {FOUR_RES}^2 steady_ms_per_iter={steady:.3f} "
          f"(block={four_cfg.block_size or 'auto'}, first block "
          f"{first_s:.2f} s)", flush=True)
    print("peak_bytes_in_use per card: "
          + " ".join(str(peak_bytes(d)) for d in devs[:4]), flush=True)
    jax.block_until_ready(four)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded vcm phase")
    args = ap.parse_args()

    devs = require_gpu()
    import smallvcm_tpu  # noqa: F401  (sets the compile cache)

    phases = Phases()
    phases.run("card", lambda: print(card_line(), flush=True))
    if args.four:
        phases.run("four cards: vcm 1024^2 sharded vs one card",
                   lambda: phase_four(devs))
    else:
        state = {}
        phases.run("seven algorithms, scene 0, 512^2",
                   lambda: phase_algorithms(devs[0], state))
        phases.run("gpu vs cpu, 64^2", phase_gpu_vs_cpu)
        phases.run("cli render", phase_cli)
        phases.run("determinism, vcm 512^2", lambda: phase_determinism(state))
    if phases.failed:
        print(f"chip_smoke: failed phases: {phases.failed}", flush=True)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
