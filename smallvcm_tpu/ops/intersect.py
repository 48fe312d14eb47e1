"""Batched ray-scene intersection over planar (SoA) vectors.

The reference does a per-ray virtual-dispatch linear scan over primitives
(geometry.hxx:55-104) — no acceleration structure (README:209). Here every
ray tests every primitive as dense [N_rays, N_prims] component-planar
computations (full vector width; see core/vec3.py) and closest hit is an
argmin over the primitive axis. At SmallVCM's primitive counts (<= ~22
triangles + 2 spheres) this is compute-trivial.

Numerics follow geometry.hxx: two-sided triangle test via three
cross-product sign agreements (:125-156) and the stable quadratic for
spheres (:198-237) in f32 (EPS_RAY=1e-3 offsets dominate residual error
at Cornell scales). All guards against 0/0 and sqrt(0) keep masked lanes
NaN-free in forward and backward passes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.vec3 import V3, dot, normalize, v3_where
from ..scene.scene import SceneData

BIG_DIST = 1e36
# Name scope of every sweep: profiler traces attribute device kernels to
# the ray sweep by it (scripts/trace_vcm.py).
SWEEP_SCOPE = "sweep"


class Hit(NamedTuple):
    hit: jnp.ndarray       # [N] bool
    dist: jnp.ndarray      # [N]
    mat_id: jnp.ndarray    # [N] int32
    light_id: jnp.ndarray  # [N] int32, -1 when the hit is not emissive
    normal: V3             # V3 of [N]
    prim: jnp.ndarray      # [N] int32 winning primitive (triangles first,
                           # then spheres), -1 on a miss


def _outer(a_n, b_t):
    """[N] x [T] -> [N,T] broadcasts for V3 components."""
    return a_n[:, None], b_t[None, :]


def _tri_distances(scene: SceneData, org: V3, direction: V3, tmin):
    """Per-(ray, triangle) hit distance, +inf when missed -> [N,T]."""
    # Broadcast V3s: rays along axis 0, triangles along axis 1.
    o = org.expand(1)        # [N,1]
    d = direction.expand(1)  # [N,1]
    p0 = scene.tri_p0.expand(0)  # [1,T]
    p1 = scene.tri_p1.expand(0)
    p2 = scene.tri_p2.expand(0)
    n = scene.tri_normal.expand(0)

    from ..core.vec3 import cross

    ao = p0 - o
    bo = p1 - o
    co = p2 - o

    v0d = dot(cross(co, bo), d)
    v1d = dot(cross(bo, ao), d)
    v2d = dot(cross(ao, co), d)

    inside = ((v0d < 0.0) & (v1d < 0.0) & (v2d < 0.0)) | (
        (v0d >= 0.0) & (v1d >= 0.0) & (v2d >= 0.0)
    )

    denom = dot(n, d)
    # denom == 0 (parallel) is a miss in the reference too (inf/NaN distance
    # fails its range checks); guard so 0/0 can't mint NaNs into the VJP.
    distance = dot(n, ao) / jnp.where(denom == 0.0, 1.0, denom)
    ok = inside & (denom != 0.0) & (distance > tmin[:, None])
    return jnp.where(ok, distance, BIG_DIST)


def _sphere_distances(scene: SceneData, org: V3, direction: V3, tmin):
    """Per-(ray, sphere) hit distance, +inf when missed -> [N,S]."""
    o = org.expand(1)
    d = direction.expand(1)
    c3 = scene.sph_center.expand(0)

    oc = o - c3  # [N,S]
    a = dot(d, d)
    bq = 2.0 * dot(d, oc)
    c = dot(oc, oc) - scene.sph_radius[None, :] ** 2

    disc = bq * bq - 4.0 * a * c
    valid = disc >= 0.0
    # Strictly positive clamp: sqrt's VJP at 0 is NaN for every missing lane.
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 1e-30))
    q = jnp.where(bq < 0.0, (-bq - sqrt_disc) * 0.5, (-bq + sqrt_disc) * 0.5)

    safe_q = jnp.where(q == 0.0, 1.0, q)
    t_a = q / a
    t_b = c / safe_q
    t0 = jnp.minimum(t_a, t_b)
    t1 = jnp.maximum(t_a, t_b)

    t0_ok = valid & (t0 > tmin[:, None])
    t1_ok = valid & (t1 > tmin[:, None])
    return jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, BIG_DIST))


@jax.named_scope(SWEEP_SCOPE)
def intersect(scene: SceneData, org: V3, direction: V3, tmin=None) -> Hit:
    """Closest-hit over all primitives; org/direction V3 of [N]."""
    n = org.x.shape[0]
    if tmin is None:
        tmin = jnp.zeros((n,), org.x.dtype)

    tri_t = _tri_distances(scene, org, direction, tmin)     # [N,T]
    sph_t = _sphere_distances(scene, org, direction, tmin)  # [N,S]
    all_t = jnp.concatenate([tri_t, sph_t], axis=1)

    best = jnp.argmin(all_t, axis=1)
    best_t = jnp.min(all_t, axis=1)
    return resolve_hit(scene, org, direction, best_t, best)


def resolve_hit(scene: SceneData, org: V3, direction: V3,
                best_t, best) -> Hit:
    """Closest-hit attribute resolution (material/normal/light) from the
    winning primitive index (tri-major; any index on miss — every
    attribute is masked by ``hit``)."""
    hit = best_t < BIG_DIST

    num_tris = scene.tri_mat.shape[0]
    is_tri = best < num_tris
    tri_idx = jnp.clip(best, 0, num_tris - 1)

    mat_id = scene.tri_mat[tri_idx]
    normal = scene.tri_normal[tri_idx]

    if scene.sph_mat.shape[0] > 0:
        sph_idx = jnp.clip(best - num_tris, 0, scene.sph_mat.shape[0] - 1)
        # Clamp miss-lane distances before forming the sphere normal:
        # squaring 1e36 overflows and normalize(0-ish) would NaN.
        t_safe = jnp.where(hit, best_t, 1.0)
        hit_p = org + direction * t_safe
        normal_sph = normalize(hit_p - scene.sph_center[sph_idx])
        mat_id = jnp.where(is_tri, mat_id, scene.sph_mat[sph_idx])
        normal = v3_where(is_tri, normal, normal_sph)

    light_id = jnp.where(hit, scene.mat_to_light[mat_id], -1)
    mat_id = jnp.where(hit, mat_id, -1)
    return Hit(hit=hit, dist=best_t, mat_id=mat_id, light_id=light_id,
               normal=normal, prim=jnp.where(hit, best, -1).astype(jnp.int32))


@jax.named_scope(SWEEP_SCOPE)
def occluded(scene: SceneData, point: V3, direction: V3, dist) -> jnp.ndarray:
    """Shadow-ray test replicating scene.hxx:72-85 exactly: origin offset by
    EPS_RAY along the direction, max distance shortened by 2*EPS_RAY."""
    from ..core.vecmath import EPS_RAY

    org = point + direction * EPS_RAY
    tmin = jnp.zeros(point.x.shape, point.x.dtype)
    tmax = dist - 2.0 * EPS_RAY

    tri_t = _tri_distances(scene, org, direction, tmin)
    sph_t = _sphere_distances(scene, org, direction, tmin)
    blocked = jnp.any(tri_t < tmax[:, None], axis=1)
    if scene.sph_mat.shape[0] > 0:
        blocked = blocked | jnp.any(sph_t < tmax[:, None], axis=1)
    return blocked
