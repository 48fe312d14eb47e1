"""Renderer driver: algorithm registry, block loop, cap sizing, time budget.

Replaces the reference's ``CreateRenderer`` factory (config.hxx:112-143) and
``render()`` execution loop (smallvcm.cxx:52-151). The reference
parallelizes by cloning one renderer per OpenMP thread and averaging their
framebuffers; here one jitted wavefront iteration already fills the
device, so the progressive loop accumulates iterations — batched ``block``
iterations per executable, with one host sync per block.

Driver design:

* Iteration batching: merging/simple algorithms run ``block`` (default 8)
  iterations per dispatch via vcm.render_block_with_stats / _simple_block;
  the only host sync is one scalar fetch per block.
* Measure-first cap sizing: merging algorithms size the photon/query
  (+XLA pair) caps from a cheap measurement program at iteration 0 (the
  largest merge radius bounds later demand), instead of discovering caps
  by render-retry, which would compile iteration 0 twice. Sized caps
  persist in a JSON sidecar so later processes skip even the measurement.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .algorithms import eyelight, pathtracer, vcm
from .scene.scene import SceneData

ALGORITHMS = ("el", "pt", "lt", "ppm", "bpm", "bpt", "vcm")

ALGORITHM_NAMES = {
    "el": "eye light",
    "pt": "path tracing",
    "lt": "light tracing",
    "ppm": "progressive photon mapping",
    "bpm": "bidirectional photon mapping",
    "bpt": "bidirectional path tracing",
    "vcm": "vertex connection and merging",
}

# VertexCM family flags: (use_vc, use_vm, light_trace_only, ppm)
# (vertexcm.hxx:222-244).
_VCM_FLAGS = {
    "lt": (False, False, True, False),
    "ppm": (False, True, False, True),
    "bpm": (False, True, False, False),
    "bpt": (True, False, False, False),
    "vcm": (True, True, False, False),
}

DEFAULT_BLOCK = 8
# el/pt carry no merge caps/overflow state, so the only cost of a bigger
# block is checkpoint granularity.
DEFAULT_BLOCK_SIMPLE = 64


@dataclass
class RenderConfig:
    """Mirror of the reference Config (config.hxx:52-109) + device knobs."""

    algorithm: str = "vcm"
    iterations: int = 1
    max_time: float = -1.0
    radius_factor: float = 0.003
    radius_alpha: float = 0.75
    base_seed: int = 1234
    max_path_length: int = 10
    min_path_length: int = 0
    resolution: tuple = (512, 512)
    rng_kind: str = "threefry"  # or "tea" (the reference's old_rng flavor)
    pair_factor: float = 24.0
    photon_factor: float = 3.0
    query_factor: float = 3.0
    # Caps frozen = sized by measurement/cache; the block loop still grows
    # them (and re-renders the block) on the rare overflow.
    merge_caps_frozen: bool = False
    # iterations per executable dispatch (0 = auto: 8, or 1 when the run
    # is shorter). Any block partition is bit-exact vs per-iteration.
    block_size: int = 0
    # multi-device execution (None => single device)
    mesh: Optional[object] = None


def ppm_downgrade_needed(scene: SceneData) -> bool:
    """PPM cannot handle mixed specular+non-specular materials; the reference
    self-downgrades to BPM after scanning the scene (vertexcm.hxx:246-278)."""
    mats = scene.materials
    diffuse = np.asarray(mats.diffuse.max_component())
    phong = np.asarray(mats.phong.max_component())
    mirror = np.asarray(mats.mirror.max_component())
    ior = np.asarray(mats.ior)
    has_non_specular = (diffuse > 0) | (phong > 0)
    has_specular = (mirror > 0) | (ior > 0)
    return bool((has_non_specular & has_specular).any())


def resolve_algorithm(scene: SceneData, algorithm: str) -> str:
    if algorithm == "ppm" and ppm_downgrade_needed(scene):
        return "bpm"
    return algorithm


def _bucket(needed: float, n: int) -> float:
    """Smallest m*2^e >= needed with mantissa m in {4,5,6,7}, as a factor
    of n (so the jit static cap args repeat exactly). The ~1.25x ladder
    keeps padding waste under ~25% (every op downstream of compaction runs
    at cap width, not live width)."""
    needed = max(needed, 1024)
    e = max(0, int(needed).bit_length() - 3)
    for m in (4, 5, 6, 7, 8):
        if m << e >= needed:
            return float(m << e) / n
    return float(8 << e) / n


# ---------------------------------------------------------------------------
# Merge-cap sizing: measure once, persist, reuse.
# ---------------------------------------------------------------------------


def _caps_cache_file() -> Path:
    root = os.environ.get("SMALLVCM_TPU_CACHE",
                          os.path.expanduser("~/.cache/smallvcm_tpu"))
    return Path(root) / "caps.json"


def _caps_key(scene: SceneData, cfg: RenderConfig, alg: str) -> str:
    res_x, res_y = cfg.resolution
    n_tri = int(scene.tri_mat.shape[0])
    n_sph = int(scene.sph_mat.shape[0])
    n_lights = int(scene.lights.kind.shape[0])
    # base_seed/rng_kind are part of the key: caps are measured at
    # iteration 0 under ONE rng stream, and a cap sized under one seed
    # can (rarely) overflow under another.
    return (
        f"{alg}|{res_x}x{res_y}|tri{n_tri}sph{n_sph}"
        f"l{n_lights}|pl{cfg.max_path_length}-{cfg.min_path_length}"
        f"|r{cfg.radius_factor}a{cfg.radius_alpha}"
        f"|s{cfg.base_seed}|{cfg.rng_kind}"
    )


def _load_cached_caps(key: str):
    try:
        data = json.loads(_caps_cache_file().read_text())
        return data.get(key)
    except (OSError, ValueError):
        return None


def _save_cached_caps(key: str, caps: dict) -> None:
    path = _caps_cache_file()
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        data = {}
    data[key] = caps
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data, indent=1, sort_keys=True))
    except OSError:
        pass


def _ensure_merge_caps(scene: SceneData, cfg: RenderConfig, alg: str,
                       use_vc: bool, ppm: bool) -> None:
    """Freeze photon/query (+pair) caps before compiling merge programs.

    Sizes from a persisted cache when available, else traces iteration 0
    (largest merge radius, vertexcm.hxx:294-299 — its demand bounds every
    later iteration) and measures demand exactly. Correctness never
    depends on this: the block loop grows caps and re-renders on any
    overflow; sizing here only avoids recompiles and padding waste.
    """
    if cfg.merge_caps_frozen:
        return
    key = _caps_key(scene, cfg, alg)
    cached = _load_cached_caps(key)
    if cached:
        cfg.pair_factor = cached["pair_factor"]
        cfg.photon_factor = cached["photon_factor"]
        cfg.query_factor = cached["query_factor"]
        cfg.merge_caps_frozen = True
        return

    res_x, res_y = cfg.resolution
    n = res_x * res_y
    traced = vcm.trace_iteration(
        scene, 0, res_x, res_y, cfg.base_seed, cfg.max_path_length,
        cfg.min_path_length, cfg.radius_factor, cfg.radius_alpha,
        use_vc, ppm, cfg.rng_kind,
    )
    demand = vcm.merge_demand_iteration(
        scene, 0, traced, res_x, res_y, cfg.radius_factor,
        cfg.radius_alpha,
    )
    pairs, n_ph, n_q = (int(v) for v in np.asarray(demand))
    cfg.pair_factor = _bucket(pairs * 1.15, n)
    cfg.photon_factor = _bucket(n_ph * 1.03, n)
    cfg.query_factor = _bucket(n_q * 1.03, n)
    cfg.merge_caps_frozen = True
    _save_cached_caps(key, dict(
        pair_factor=cfg.pair_factor, photon_factor=cfg.photon_factor,
        query_factor=cfg.query_factor,
    ))


# ---------------------------------------------------------------------------
# Block runners. Each returns (image_sum, iterations_rendered).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=(
    "alg", "res_x", "res_y", "base_seed", "max_path_length",
    "min_path_length", "rng_kind", "block",
))
def _simple_block(
    scene, start_iteration, alg: str, res_x: int, res_y: int,
    base_seed: int, max_path_length: int, min_path_length: int,
    rng_kind: str, block: int,
):
    """``block`` el/pt iterations in one executable -> (sum image, lum)."""

    def body(j, acc):
        it = start_iteration + j
        if alg == "el":
            img = eyelight.render_iteration(
                scene, it, res_x, res_y, base_seed, rng_kind=rng_kind
            )
        else:
            img = pathtracer.render_iteration(
                scene, it, res_x, res_y, base_seed, max_path_length,
                min_path_length, rng_kind=rng_kind,
            )
        return acc + img

    acc = jax.lax.fori_loop(
        0, block, body, jnp.zeros((res_y, res_x, 3), jnp.float32)
    )
    return acc, jnp.sum(acc)


def _make_block_runner(scene: SceneData, cfg: RenderConfig, alg: str):
    """Build run(start, k) -> image_sum for the resolved algorithm/backend.

    The runner handles overflow-grow-retry internally (merging only) and
    performs exactly one host sync per call.
    """
    res_x, res_y = cfg.resolution
    n = res_x * res_y

    if alg in ("el", "pt"):
        if cfg.mesh is not None:
            from .parallel.sharding import sharded_simple_iteration

            def run_sharded_simple(start, k):
                acc = jnp.zeros((res_y, res_x, 3), jnp.float32)
                for j in range(k):
                    acc = acc + sharded_simple_iteration(
                        cfg.mesh, alg, scene, start + j, res_x, res_y,
                        cfg.base_seed, cfg.max_path_length,
                        cfg.min_path_length, cfg.rng_kind,
                    )
                jax.device_get(acc[0, 0])
                return acc

            return run_sharded_simple

        def run_simple(start, k):
            acc, lum = _simple_block(
                scene, start, alg, res_x, res_y, cfg.base_seed,
                cfg.max_path_length, cfg.min_path_length, cfg.rng_kind, k,
            )
            jax.device_get(lum)
            return acc

        return run_simple

    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    if use_vm and cfg.mesh is None:
        _ensure_merge_caps(scene, cfg, alg, use_vc, ppm)

    caps_key = _caps_key(scene, cfg, alg)

    def run_block(start, k):
        while True:
            # Chunk the merge only when pair arrays would exceed ~16M
            # rows (~1.4 GB @ ~21 int32/row) — chunking costs a little
            # and its uneven pair split needs slack (vcm.merge_stage).
            chunks = 1 if not use_vm else max(
                1, int(-(-int(cfg.pair_factor * n) // (16 << 20))))
            if cfg.mesh is not None:
                from .parallel.sharding import (
                    sharded_render_iteration_with_stats,
                )

                acc = jnp.zeros((res_y, res_x, 3), jnp.float32)
                ovf = jnp.zeros((), jnp.int32)
                stats = jnp.zeros((3,), jnp.int32)
                for j in range(k):
                    fb, _r, o, st = sharded_render_iteration_with_stats(
                        cfg.mesh, scene, start + j, res_x, res_y,
                        cfg.base_seed, cfg.max_path_length,
                        cfg.min_path_length, cfg.radius_factor,
                        cfg.radius_alpha, use_vc=use_vc, use_vm=use_vm,
                        light_trace_only=lt_only, ppm=ppm,
                        pair_factor=cfg.pair_factor,
                        photon_factor=cfg.photon_factor,
                        query_factor=cfg.query_factor,
                        rng_kind=cfg.rng_kind, merge_chunks=chunks,
                    )
                    acc = acc + fb
                    ovf = ovf + o
                    stats = jnp.maximum(stats, st)
            else:
                acc, _rays, ovf, stats, _lum = vcm.render_block_with_stats(
                    scene, start, res_x, res_y, k, cfg.base_seed,
                    cfg.max_path_length, cfg.min_path_length,
                    cfg.radius_factor, cfg.radius_alpha,
                    use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only,
                    ppm=ppm, pair_factor=cfg.pair_factor,
                    photon_factor=cfg.photon_factor,
                    query_factor=cfg.query_factor, rng_kind=cfg.rng_kind,
                    merge_chunks=chunks,
                )
            if not use_vm:
                jax.device_get(ovf)
                return acc
            ovf_v, stats_v = jax.device_get((ovf, stats))
            if int(ovf_v) == 0:
                return acc
            pairs, n_ph, n_q = (int(v) for v in stats_v)
            n_shard = n if cfg.mesh is None else \
                n // cfg.mesh.devices.size
            # Grow every cap to measured need (monotonic: a photon/query
            # overflow can hide pairs) and re-render the SAME block —
            # exact, because the RNG is counter-based.
            cfg.pair_factor = max(
                _bucket(pairs * 1.1, n_shard),
                _bucket(cfg.pair_factor * n_shard * 1.26, n_shard))
            cfg.photon_factor = max(
                cfg.photon_factor, _bucket(n_ph * 1.1, n_shard))
            cfg.query_factor = max(
                cfg.query_factor, _bucket(n_q * 1.1, n_shard))
            if cfg.mesh is None:
                _save_cached_caps(caps_key, dict(
                    pair_factor=cfg.pair_factor,
                    photon_factor=cfg.photon_factor,
                    query_factor=cfg.query_factor,
                ))
            print(f"[smallvcm_tpu] merge cap overflow; re-rendering block "
                  f"at iteration {start} with "
                  f"pair_factor={cfg.pair_factor} "
                  f"photon_factor={cfg.photon_factor} "
                  f"query_factor={cfg.query_factor}", flush=True)

    return run_block


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def auto_block_size(cfg: RenderConfig, alg: str) -> int:
    """Iterations per dispatch. Scales inversely with resolution so one
    dispatch stays ~seconds of device time while per-iteration work grows
    ~quadratically (paths x photon density at a fixed merge radius).
    bench.py reuses this so its timings match production dispatch shapes.
    """
    n_pix = cfg.resolution[0] * cfg.resolution[1]
    base_block = (DEFAULT_BLOCK_SIMPLE if alg in ("el", "pt")
                  else DEFAULT_BLOCK)
    return cfg.block_size or max(
        1, min(base_block, (base_block * 512 * 512) // max(n_pix, 1))
    )


def render_single_iteration(
    scene: SceneData, cfg: RenderConfig, iteration: int
) -> jnp.ndarray:
    """One iteration through the production block machinery (block = 1).

    Kept for tests/benches and the sharded path; production rendering goes
    through :func:`render`, which batches iterations.
    """
    alg = resolve_algorithm(scene, cfg.algorithm)
    runner = _make_block_runner(scene, cfg, alg)
    return runner(iteration, 1)


def render(scene: SceneData, cfg: RenderConfig, verbose: bool = False,
           accum=None, start_iter: int = 0, block_cb=None):
    """Progressive render. Returns (image [resY,resX,3], seconds, iters).

    Like smallvcm.cxx:52-151: -t (max_time) takes precedence over -i; the
    returned image is the average over completed iterations. ``accum`` /
    ``start_iter`` resume a previous accumulation (checkpoint.py);
    ``block_cb(accum, iterations_done)`` fires after every completed
    block (the checkpoint hook). With ``verbose``, prints per-block
    metrics (mean luminance + wall time — the observability surface the
    reference defines but never calls, framebuffer.hxx:89-102).
    """
    from .io.framebuffer import total_luminance

    res_x, res_y = cfg.resolution
    alg = resolve_algorithm(scene, cfg.algorithm)
    runner = _make_block_runner(scene, cfg, alg)

    accum = (jnp.zeros((res_y, res_x, 3), jnp.float32)
             if accum is None else accum)
    done = start_iter
    auto_block = auto_block_size(cfg, alg)

    def step(k):
        nonlocal accum, done
        t0 = time.time()
        accum = accum + runner(done, k)
        done += k
        if verbose:
            lum = float(total_luminance(accum)) / max(done, 1)
            print(f"  iter {done - k}..{done - 1}: luminance={lum:.1f} "
                  f"dt={time.time() - t0:.3f}s", flush=True)
        if block_cb is not None:
            block_cb(accum, done)

    start = time.time()
    if cfg.max_time > 0:
        # First two iterations run singly: they settle caps and give a
        # per-iteration time estimate before committing to full blocks.
        # Block sizes are restricted to {1, auto_block}, which bounds the
        # compiled programs per run (el/pt compile one per block size).
        while time.time() - start < cfg.max_time:
            rendered = done - start_iter
            if rendered < 2:
                step(1)
                continue
            dt_iter = (time.time() - start) / rendered
            left = cfg.max_time - (time.time() - start)
            k = auto_block if left >= dt_iter * auto_block else 1
            step(k)
    else:
        # Full blocks then singles. The schedule is a pure function of
        # ``done``, so a resumed run reproduces the original partition
        # and the accumulation association — resume stays bit-exact
        # (tests/test_cli_checkpoint.py).
        target = cfg.iterations
        while done < target:
            k = auto_block if target - done >= auto_block else 1
            step(k)
    elapsed = time.time() - start

    # ``done`` counts ALL accumulated iterations (including a resumed
    # prefix), which is also the averaging divisor; with start_iter == 0
    # it equals the iterations rendered by this call.
    img = accum / done if done > 0 else accum
    return img, elapsed, done
