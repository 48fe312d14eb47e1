"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

New capability over the reference (which has no gradients): the whole
wavefront pipeline — path tracing, BPT connections, and VCM photon merging —
is jax.grad-able w.r.t. a parameter pytree of material reflectances, Phong
exponents, IORs, and light intensities.

Gradient strategy (see ops/bsdf.py): all probabilities stay live under AD.
Discrete decisions (BSDF lobe choice, Russian roulette) are u < threshold
comparisons with zero derivative a.e.; because survivors carry 1/probability
weights, differentiating through those live weights exactly compensates the
decision-boundary terms — the estimator's gradient is unbiased. Continuous
sampling transforms (e.g. the Phong-exponent power-cosine lobe) contribute
standard reparameterized gradients.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .core.vec3 import V3
from .scene.scene import Materials, SceneData


class Params(NamedTuple):
    """Differentiable scene parameters (V3 = component-planar color)."""

    diffuse: V3                   # V3 of [M]
    phong: V3                     # V3 of [M]
    exponent: jnp.ndarray         # [M]
    mirror: V3                    # V3 of [M]
    ior: jnp.ndarray              # [M]
    light_intensity: V3           # V3 of [L]


def extract_params(scene: SceneData) -> Params:
    m = scene.materials
    return Params(
        diffuse=m.diffuse,
        phong=m.phong,
        exponent=m.exponent,
        mirror=m.mirror,
        ior=m.ior,
        light_intensity=scene.lights.intensity,
    )


def apply_params(scene: SceneData, params: Params) -> SceneData:
    mats = Materials(
        diffuse=params.diffuse,
        phong=params.phong,
        exponent=params.exponent,
        mirror=params.mirror,
        ior=params.ior,
    )
    lights = scene.lights._replace(intensity=params.light_intensity)
    return scene.replace(materials=mats, lights=lights)


@partial(
    jax.jit,
    static_argnames=(
        "algorithm", "res_x", "res_y", "base_seed", "max_path_length",
        "min_path_length", "pair_factor", "photon_factor", "query_factor",
    ),
)
def render_params(
    scene: SceneData,
    params: Params,
    iteration,
    algorithm: str,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
) -> jnp.ndarray:
    """One iteration of the given algorithm with params substituted.

    The merge caps (pair/photon/query factors) are exposed so inverse
    rendering at larger resolutions can use driver-sized caps (see
    render.py's measure-first sizing) instead of the defaults.
    """
    from .algorithms import pathtracer, vcm
    from .render import _VCM_FLAGS

    s = apply_params(scene, params)
    if algorithm == "pt":
        return pathtracer.render_iteration(
            s, iteration, res_x, res_y, base_seed, max_path_length,
            min_path_length,
        )
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[algorithm]
    return vcm.render_iteration(
        s, iteration, res_x, res_y, base_seed, max_path_length,
        min_path_length, radius_factor, radius_alpha,
        use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only, ppm=ppm,
        pair_factor=pair_factor, photon_factor=photon_factor,
        query_factor=query_factor,
    )


def loss_and_grad(
    scene: SceneData,
    params: Params,
    target: jnp.ndarray,
    iteration,
    algorithm: str,
    res_x: int,
    res_y: int,
    n_iterations: int = 1,
    **kw,
):
    """L2 image loss against a target and its gradient w.r.t. params.

    Averages ``n_iterations`` stochastic render iterations before the loss so
    inverse-rendering steps see a lower-variance image.
    """

    def loss_fn(p):
        # lax.scan over iterations: the body is traced ONCE, so compile
        # time is independent of n_iterations (a Python loop would unroll
        # it, compiling in linear time). jax.checkpoint bounds reverse-mode
        # memory to one iteration of residuals (recompute in backward).
        @jax.checkpoint
        def one(p, i):
            return render_params(
                scene, p, iteration * n_iterations + i, algorithm,
                res_x, res_y, **kw,
            )

        def body(acc, i):
            return acc + one(p, i), None

        img, _ = jax.lax.scan(
            body, jnp.zeros((res_y, res_x, 3), jnp.float32),
            jnp.arange(n_iterations),
        )
        img = img / n_iterations
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


def sharded_loss_and_grad(
    mesh,
    scene: SceneData,
    params: Params,
    target: jnp.ndarray,
    iteration,
    algorithm: str,
    res_x: int,
    res_y: int,
    n_iterations: int = 1,
    vm_exchange: str = "allgather",
    **kw,
):
    """Mesh-aware ``loss_and_grad``: paths sharded over ``mesh``.

    The forward pass is the production sharded program
    (parallel/sharding.py::sharded_render_iteration — light vertices
    all-gathered or ring-exchanged for merging, framebuffer psum); the
    backward pass runs through shard_map's transpose rules, so parameter
    gradients are psum-reduced across shards exactly as SURVEY §2's comm
    table specifies ("psum (framebuffer, grads)"). Placement follows
    training_step_spec: params/target replicated, path ids sharded.
    Always uses the XLA merge (the differentiable backend).
    """
    from .parallel.sharding import (
        sharded_render_iteration, training_step_spec,
    )
    from .render import _VCM_FLAGS

    replicated, _paths = training_step_spec(mesh)
    params = jax.device_put(params, replicated)
    target = jax.device_put(target, replicated)
    use_vc, use_vm, lt_only, ppm = (
        (False, False, False, False) if algorithm == "pt"
        else _VCM_FLAGS[algorithm]
    )

    def loss_fn(p):
        s = apply_params(scene, p)
        img = jnp.zeros((res_y, res_x, 3), jnp.float32)
        for i in range(n_iterations):
            def one(s_, it=iteration * n_iterations + i):
                if algorithm in ("el", "pt"):
                    from .parallel.sharding import sharded_simple_iteration
                    return sharded_simple_iteration(
                        mesh, algorithm, s_, it, res_x, res_y, **kw,
                    )
                return sharded_render_iteration(
                    mesh, s_, it, res_x, res_y,
                    use_vc=use_vc, use_vm=use_vm,
                    light_trace_only=lt_only, ppm=ppm,
                    vm_exchange=vm_exchange, **kw,
                )
            img = img + (jax.checkpoint(one)(s) if n_iterations > 1
                         else one(s))
        img = img / n_iterations
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)
