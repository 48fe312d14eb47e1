"""Trace one vcm iteration on a GPU and report the ray sweep's share of it.

    python scripts/trace_vcm.py [--res 512] [--out chiprun_out/trace_vcm]

Renders scene 0 through the production block program
(vcm.render_block_with_stats, merge caps sized by the driver), compiled
once and warmed up, then traces one block of one iteration with
jax.profiler. Device kernels are attributed to the ray sweep through the
op_name metadata of the compiled HLO: a kernel counts when its HLO
instruction's op_name lies under the ``sweep`` name scope
(ops/intersect.py). XLA's command buffers (CUDA graphs) are switched off
for this process, because a graph shows in the trace as one event with no
HLO op of its own; launching kernels one by one costs a little more host
time than the production program. Prints one JSON line; the trace stays
in ``--out``. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_HLO_LINE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*metadata=\{op_name="([^"]*)"')


def op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata, from compiled HLO text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def kernel_events(xplane_path: str):
    """(hlo_op, start_ns, duration_ns) of every device kernel event (on a
    CPU, of every event that names an HLO op)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    found = {True: [], False: []}
    for plane in pd.planes:
        on_device = plane.name.startswith("/device:")
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                if "hlo_op" in stats:
                    found[on_device].append(
                        (str(stats["hlo_op"]), e.start_ns, e.duration_ns))
    return found[True] or found[False]


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _op, start, dur in sorted(events, key=lambda ev: ev[1]):
        stop = start + dur
        if start >= end:
            total += dur
        elif stop > end:
            total += stop - end
        end = max(end, stop)
    return total


def sweep_share(events, names: dict, scope: str) -> dict:
    tag = f"/{scope}/"
    kernel = sum(d for _, _, d in events)
    sweep_ev = [ev for ev in events if tag in names.get(ev[0], "")]
    by_op = {}
    for op, _, d in events:
        by_op[op] = by_op.get(op, 0.0) + d
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "kernel_events": len(events),
        "kernel_ms": kernel / 1e6,
        "device_busy_ms": busy_ns(events) / 1e6,
        "sweep_ms": sum(d for _, _, d in sweep_ev) / 1e6,
        "sweep_share_of_kernel_time": (
            sum(d for _, _, d in sweep_ev) / kernel if kernel else 0.0),
        "unmapped_ops": sorted({op for op, _, _ in events
                                if op not in names})[:10],
        "top_ops_ms": [(op, ms / 1e6, tag in names.get(op, ""))
                       for op, ms in top],
    }


def trace_one_iteration(res: int, out_dir: str) -> dict:
    import jax
    import jax.numpy as jnp

    from smallvcm_tpu import render as R
    from smallvcm_tpu.algorithms import vcm
    from smallvcm_tpu.ops.intersect import SWEEP_SCOPE
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((res, res), SCENE_CONFIGS[0])
    cfg = R.RenderConfig(algorithm="vcm", resolution=(res, res))
    R._make_block_runner(scene, cfg, "vcm")        # sizes the merge caps
    static = dict(pair_factor=cfg.pair_factor,
                  photon_factor=cfg.photon_factor,
                  query_factor=cfg.query_factor)

    @jax.jit
    def block(sc, start, k):
        return vcm.render_block_with_stats(sc, start, res, res, k, **static)

    one = jnp.int32(1)
    t0 = time.perf_counter()
    compiled = block.lower(scene, jnp.int32(0), one).compile()
    compile_s = time.perf_counter() - t0
    for it in range(2):
        jax.block_until_ready(compiled(scene, jnp.int32(it), one))
    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(scene, jnp.int32(2), one))
        wall_ms = (time.perf_counter() - t0) * 1e3
    xplane = sorted(glob.glob(os.path.join(
        out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    rec = {"res": res, "compile_s": compile_s, "iteration_wall_ms": wall_ms}
    rec.update(sweep_share(kernel_events(xplane),
                           op_names(compiled.as_text()), SWEEP_SCOPE))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--out", default="chiprun_out/trace_vcm")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"trace_vcm: no GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    rec = {"card": card, "kind": dev.device_kind}
    rec.update(trace_one_iteration(args.res, args.out))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
