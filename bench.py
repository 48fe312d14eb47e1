"""Benchmark: rays/s on one GPU vs the reference CPU (+ all algorithms).

Default: times VCM on scene 0 at 512x512 and prints ONE JSON line on stdout:
  {"metric": "rays/sec/chip (VCM, scene 0, 512x512)", "value": N,
   "unit": "rays/s", "vs_baseline": N, "device": {...}}

``--full`` also times all 7 algorithms (steady-state ms/iteration, with the
first block — cap sizing, compile, one block — reported apart), in this
same process. All extra output goes to stderr.

Measured through the production block driver (render.py): auto-sized
blocks, measure-first merge caps — the same machinery the CLI runs. The
first block of every runner is set-up; the timed blocks follow it.

Ray count = path segments + shadow/occlusion rays actually enabled (the same
work the reference performs per iteration; lanes masked off are not counted,
so this is conservative for the wavefront design). The baseline divides the
identical ray count by the reference's measured per-iteration time on a
2-core x86 CPU (BASELINE.md: vcm scene 0, 1 iter = 1.6 s core-seconds).

Exits non-zero when JAX finds no GPU: a CPU timing is not this benchmark.
"""

import argparse
import json
import sys
import time

import jax

REFERENCE_VCM_SCENE0_SECONDS = 1.6  # BASELINE.md

# Reference CPU seconds/iteration (BASELINE.md table), scene 0, 512x512,
# for the per-algorithm vs_ref_cpu columns.
REFERENCE_SECONDS = {
    "el": 0.07, "pt": 0.60, "lt": 0.32, "ppm": 0.52, "bpm": 1.17,
    "bpt": 1.11, "vcm": 1.60,
}

TIMED_BLOCKS = 3


def _eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_algorithm(alg, scene, res):
    """(steady seconds/iteration, first-block seconds, resolved config)
    for one algorithm through the production driver."""
    from smallvcm_tpu import render as R

    cfg = R.RenderConfig(algorithm=alg, resolution=(res, res))
    block = R.auto_block_size(cfg, alg)
    t0 = time.perf_counter()
    runner = R._make_block_runner(scene, cfg, alg)
    runner(0, block)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in range(TIMED_BLOCKS):
        runner((b + 1) * block, block)
    steady = (time.perf_counter() - t0) / (TIMED_BLOCKS * block)
    resolved = {
        "block": block,
        "pair_factor": cfg.pair_factor,
        "photon_factor": cfg.photon_factor,
        "query_factor": cfg.query_factor,
    }
    return steady, first, resolved


def vcm_rays_per_iteration(scene, res):
    """Traced rays of one vcm iteration."""
    from smallvcm_tpu import render as R
    from smallvcm_tpu.algorithms import vcm

    cfg = R.RenderConfig(algorithm="vcm", resolution=(res, res))
    R._make_block_runner(scene, cfg, "vcm")   # sizes the caps
    _acc, rays, _ovf, _stats, _lum = vcm.render_block_with_stats(
        scene, 1, res, res, 1,
        pair_factor=cfg.pair_factor, photon_factor=cfg.photon_factor,
        query_factor=cfg.query_factor,
    )
    return int(rays)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also bench all 7 algorithms")
    args = ap.parse_args()

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    _eprint(f"device: {device}")
    if device["platform"] != "gpu":
        _eprint("bench.py: no GPU found; refusing to report CPU timings")
        return 2

    from smallvcm_tpu.render import ALGORITHMS
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    res = 512
    scene = load_cornell_box((res, res), SCENE_CONFIGS[0])

    algorithms = {}
    for alg in (ALGORITHMS if args.full else ("vcm",)):
        steady, first, resolved = bench_algorithm(alg, scene, res)
        ref = REFERENCE_SECONDS[alg]
        algorithms[alg] = {"steady_ms": steady * 1e3, "first_block_s": first,
                           "vs_ref_cpu": ref / steady, "resolved": resolved}
        _eprint(f"{alg}: {steady * 1e3:.3f} ms/iter steady (first block "
                f"{first:.2f} s incl. sizing/compile) — "
                f"{ref / steady:.1f}x reference CPU")

    rays = vcm_rays_per_iteration(scene, res)
    dt = algorithms["vcm"]["steady_ms"] / 1e3
    rays_per_sec = rays / dt
    baseline = rays / REFERENCE_VCM_SCENE0_SECONDS
    print(json.dumps({
        "metric": "rays/sec/chip (VCM, scene 0, 512x512)",
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / baseline,
        "device": device,
        "algorithms": algorithms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
