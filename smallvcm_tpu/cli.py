"""Command-line interface with the reference's flags and defaults.

Replicates ParseCommandline (config.hxx:225-388) and main (smallvcm.cxx:
268-326): ``-s <scene> -a <alg> -t <sec> -i <iters> -o <name> --report``,
plus device knobs. ``-t`` takes precedence over ``-i``. Default output
name is e.g. ``gbs_s_vcm.bmp`` (config.hxx:153-174).
"""

from __future__ import annotations

import argparse
import sys

from .render import ALGORITHM_NAMES, ALGORITHMS, RenderConfig, render, resolve_algorithm
from .scene.scene import SCENE_CONFIGS, get_scene_name, load_cornell_box
from .io.framebuffer import save_image


def build_default_filename(scene_config: int, algorithm: str) -> str:
    """config.hxx:153-174: 'g' prefix for glossy floor + scene acronym."""
    from .scene.scene import GLOSSY_FLOOR

    name = "g" if (scene_config & GLOSSY_FLOOR) else ""
    _, acronym = get_scene_name(scene_config)
    name += acronym
    name += f"_{algorithm}.bmp"
    return name


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smallvcm_tpu",
        description="SmallVCM in JAX: 7 light-transport algorithms over "
        "4 Cornell-box scenes (JAX/XLA wavefront renderer).",
    )
    scene_lines = "; ".join(
        f"{i}={get_scene_name(c)[0]}" for i, c in enumerate(SCENE_CONFIGS)
    )
    p.add_argument("-s", type=int, default=0, dest="scene_id",
                   help=f"scene id (default 0): {scene_lines}")
    alg_lines = "; ".join(
        f"{a}={ALGORITHM_NAMES[a]}" for a in ALGORITHMS
    )  # acronym + full name, as PrintHelp does (config.hxx:196-210)
    p.add_argument("-a", type=str, default=None, dest="algorithm",
                   choices=ALGORITHMS,
                   help=f"algorithm (default vcm): {alg_lines}")
    p.add_argument("-t", type=float, default=-1.0, dest="max_time",
                   help="seconds to run (takes precedence over -i)")
    p.add_argument("-i", type=int, default=1, dest="iterations",
                   help="iterations to run (default 1)")
    p.add_argument("-o", type=str, default="", dest="output_name",
                   help="output name with .bmp or .hdr extension")
    p.add_argument("--report", action="store_true",
                   help="render all scenes x algorithms and emit index.html")
    p.add_argument("--resolution", type=int, nargs=2, default=(512, 512),
                   metavar=("X", "Y"))
    p.add_argument("--max-path-length", type=int, default=10)
    p.add_argument("--min-path-length", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--radius-factor", type=float, default=0.003)
    p.add_argument("--radius-alpha", type=float, default=0.75)
    p.add_argument("--rng", type=str, default="threefry",
                   choices=("threefry", "tea"), dest="rng_kind",
                   help="counter-based generator; 'tea' is the reference's "
                        "LEGACY_RNG mixing function (its old_rng flavor)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard paths over this many devices "
                        "(0 = all local; 1 forces single-device)")
    p.add_argument("--block", type=int, default=0, dest="block_size",
                   help="iterations per device dispatch (0 = auto: 8; "
                        "any block partition is bit-exact)")
    p.add_argument("--checkpoint", default="", dest="checkpoint",
                   help="checkpoint file; resumes from it if present")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every",
                   help="save the checkpoint every N iterations")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-iteration luminance/timing metrics")
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = make_parser().parse_args(argv)

    if args.report:
        from .report import full_report

        full_report(args)
        return 0

    if args.scene_id < 0 or args.scene_id >= len(SCENE_CONFIGS):
        print("Invalid <sceneID> argument, please see help (-h)")
        return 1

    algorithm = args.algorithm or "vcm"
    scene_config = SCENE_CONFIGS[args.scene_id]
    scene = load_cornell_box(tuple(args.resolution), scene_config)
    scene_name, _ = get_scene_name(scene_config)

    mesh = None
    if args.devices != 1:
        import jax

        n_avail = len(jax.devices())
        want = args.devices if args.devices > 0 else n_avail
        if want > n_avail:
            print(f"Requested --devices {want} but only {n_avail} "
                  "available")
            return 1
        n_pix = args.resolution[0] * args.resolution[1]
        if want > 1 and n_pix % want != 0:
            print(f"Resolution {args.resolution[0]}x{args.resolution[1]} "
                  f"({n_pix} paths) not divisible by {want} devices")
            return 1
        if want > 1:
            from .parallel.sharding import make_mesh

            mesh = make_mesh(want)
            print(f"Devices: {want} (paths sharded over a 1-D mesh)")

    cfg = RenderConfig(
        algorithm=algorithm,
        iterations=args.iterations,
        max_time=args.max_time,
        radius_factor=args.radius_factor,
        radius_alpha=args.radius_alpha,
        base_seed=args.seed,
        max_path_length=args.max_path_length,
        min_path_length=args.min_path_length,
        resolution=tuple(args.resolution),
        rng_kind=args.rng_kind,
        block_size=args.block_size,
        mesh=mesh,
    )

    output = args.output_name or build_default_filename(scene_config, algorithm)
    if not (output.endswith(".bmp") or output.endswith(".hdr")):
        output += ".bmp"

    print(f"Scene:   {scene_name}")
    if cfg.max_time > 0:
        print(f"Target:  {cfg.max_time} seconds render time")
    else:
        print(f"Target:  {cfg.iterations} iteration(s)")

    resolved = resolve_algorithm(scene, algorithm)
    if resolved != algorithm:
        print("Switching from PPM to BPM (scene mixes specular and "
              "non-specular materials)")
    print(f"Running: {ALGORITHM_NAMES[algorithm]}...",
          end="\n" if args.verbose else " ", flush=True)
    if args.checkpoint:
        from .checkpoint import render_resumable

        img, elapsed, iters = render_resumable(
            scene, cfg, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, verbose=args.verbose,
        )
    else:
        img, elapsed, iters = render(scene, cfg, verbose=args.verbose)
    print(f"done in {elapsed:.2f} s ({iters} iterations)")

    save_image(img, output)
    print(f"Saved:   {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
