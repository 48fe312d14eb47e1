"""Multi-chip / multi-host execution: shard paths over a device mesh.

The reference parallelizes by cloning the renderer per OpenMP thread and
summing framebuffers (smallvcm.cxx:61-142), which makes results depend on
thread count. Here the *path/pixel batch* is sharded over a 1-D ``paths``
mesh axis with ``shard_map``:

- camera path i and light path i share a shard (the only pairing the VC
  stage needs, vertexcm.hxx:498-526), so vertex connection is shard-local;
- light vertices are all-gathered across the mesh for the merging stage;
- each shard scatters light-tracing splats into its own full framebuffer
  copy, reduced with ``psum``;
- the counter-based RNG keys off global path ids, so the image is
  bit-identical for any device count — strictly stronger than the
  reference's thread-seeded scheme.

Multi-host: the same code runs under ``jax.distributed.initialize`` with a
global mesh. The mesh is a plain 1-D device list: with every card
reaching every other at the same rate (NVLink), no device order is
better than another.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..algorithms import vcm
from ..scene.scene import SceneData

AXIS = "paths"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (AXIS,))


def _global_pix(mesh: Mesh, n: int):
    """Global path-id array [n] sharded over the mesh's ``paths`` axis.

    Built shard-by-shard with make_array_from_callback so it is valid on a
    multi-process (multi-controller) global mesh, where a host-local
    jnp.arange cannot be resharded implicitly. Single-process meshes get
    the identical array.
    """
    import numpy as np

    sharding = NamedSharding(mesh, P(AXIS))
    return jax.make_array_from_callback(
        (n,), sharding,
        lambda idx: np.arange(n, dtype=np.uint32)[idx],
    )


def sharded_render_iteration(
    mesh: Mesh,
    scene: SceneData,
    iteration,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    vm_exchange: str = "allgather",
    rng_kind: str = "threefry",
    merge_chunks: int = 1,
) -> jnp.ndarray:
    """One VCM-family iteration with paths sharded over ``mesh``.

    ``vm_exchange`` picks the cross-shard photon exchange for merging:
    "allgather" materializes the global photon map on every shard (one
    hop, highest bandwidth); "ring" keeps photons sharded and ppermutes
    them around the mesh, merging one visiting shard at a time — the
    ring-attention pattern, for photon maps too large to replicate.
    Both are exact (merging is additive over photons).

    Returns the full accumulation image, replicated.
    """
    fb, _rays, _overflow, _stats = sharded_render_iteration_with_stats(
        mesh, scene, iteration, res_x, res_y, base_seed, max_path_length,
        min_path_length, radius_factor, radius_alpha, use_vc, use_vm,
        light_trace_only, ppm, pair_factor, photon_factor, query_factor,
        vm_exchange, rng_kind, merge_chunks,
    )
    return fb


def sharded_render_iteration_with_stats(
    mesh: Mesh,
    scene: SceneData,
    iteration,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    vm_exchange: str = "allgather",
    rng_kind: str = "threefry",
    merge_chunks: int = 1,
):
    """Like sharded_render_iteration but returns the full
    (fb, ray_count, merge_overflow, merge_stats) tuple (psum-reduced over
    shards) so drivers can run the same cap-sizing ladder as the
    single-device path. Per-shard merge caps are ``factor * shard_size``,
    so the total capacity matches the single-device configuration."""
    n = res_x * res_y
    n_dev = mesh.devices.size
    if n % n_dev != 0:
        raise ValueError(f"path count {n} not divisible by {n_dev} devices")

    run = _vcm_program(
        mesh, res_x, res_y, base_seed, max_path_length, min_path_length,
        radius_factor, radius_alpha, use_vc, use_vm, light_trace_only,
        ppm, pair_factor, photon_factor, query_factor, vm_exchange,
        rng_kind, merge_chunks,
    )
    return run(scene, jnp.asarray(iteration, jnp.int32), _global_pix(mesh, n))


# One COMPILED program per (mesh, static config): shard_map called bare
# executes eagerly (per-primitive dispatch across the mesh — a
# dryrun-timeout regression), so the program must be built once, wrapped in
# jax.jit, and cached. ``iteration`` stays a traced argument so the
# progressive loop reuses one executable for every iteration.
_VCM_PROGRAMS: dict = {}


def _vcm_program(
    mesh, res_x, res_y, base_seed, max_path_length, min_path_length,
    radius_factor, radius_alpha, use_vc, use_vm, light_trace_only, ppm,
    pair_factor, photon_factor, query_factor, vm_exchange, rng_kind,
    merge_chunks,
):
    key = (
        mesh, res_x, res_y, base_seed, max_path_length, min_path_length,
        radius_factor, radius_alpha, use_vc, use_vm, light_trace_only,
        ppm, pair_factor, photon_factor, query_factor, vm_exchange,
        rng_kind, merge_chunks,
    )
    cached = _VCM_PROGRAMS.get(key)
    if cached is not None:
        return cached

    n = res_x * res_y

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS)),
        out_specs=(P(), P(), P(), P()),
        # Loop carries start as zeros (replicated) and become shard-varying
        # inside fori_loop; skip the static varying-axes check.
        check_vma=False,
    )
    def run(scene_rep, iteration, pix_shard):
        return vcm.render_iteration_core(
            scene_rep, iteration, pix_shard, res_x, res_y, n, base_seed,
            max_path_length, min_path_length, radius_factor, radius_alpha,
            use_vc, use_vm, light_trace_only, ppm, pair_factor,
            photon_factor, query_factor, vm_exchange, rng_kind,
            merge_chunks=merge_chunks, axis_name=AXIS,
        )

    run = jax.jit(run)
    _VCM_PROGRAMS[key] = run
    return run


_SIMPLE_PROGRAMS: dict = {}


def sharded_simple_iteration(
    mesh: Mesh,
    algorithm: str,
    scene: SceneData,
    iteration,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    rng_kind: str = "threefry",
) -> jnp.ndarray:
    """One eyelight / path-tracer iteration with pixels sharded over
    ``mesh``: each shard renders its slice of global pixel ids into a
    full-resolution framebuffer, reduced with psum. Bit-compatible with the
    single-device image up to reduction order (counter-based RNG keys off
    global pixel ids)."""
    n = res_x * res_y
    n_dev = mesh.devices.size
    if n % n_dev != 0:
        raise ValueError(f"pixel count {n} not divisible by {n_dev} devices")

    key = (
        mesh, algorithm, res_x, res_y, base_seed, max_path_length,
        min_path_length, rng_kind,
    )
    run = _SIMPLE_PROGRAMS.get(key)
    if run is None:
        from ..algorithms import eyelight, pathtracer

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS)),
            out_specs=P(),
            check_vma=False,
        )
        def run(scene_rep, iteration, pix_shard):
            if algorithm == "el":
                fb = eyelight.render_core(
                    scene_rep, iteration, pix_shard, res_x, res_y,
                    base_seed, rng_kind,
                )
            else:
                fb = pathtracer.render_core(
                    scene_rep, iteration, pix_shard, res_x, res_y,
                    base_seed, max_path_length, min_path_length, rng_kind,
                )
            return jax.lax.psum(fb, AXIS)

        run = jax.jit(run)
        _SIMPLE_PROGRAMS[key] = run

    return run(scene, jnp.asarray(iteration, jnp.int32), _global_pix(mesh, n))


def training_step_spec(mesh: Mesh):
    """Shardings for the differentiable-render 'training step': scene params
    replicated, paths sharded, gradients psum-reduced (see diff.py)."""
    return NamedSharding(mesh, P()), NamedSharding(mesh, P(AXIS))
