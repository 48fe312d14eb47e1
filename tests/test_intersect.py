"""Closest-hit and shadow-ray sweeps against a float64 brute-force oracle.

ops/intersect.py tests every ray against every primitive in f32; the
oracle below is the same two-sided triangle test (geometry.hxx:125-156)
and stable sphere quadratic (:198-237) evaluated in numpy float64, one
ray at a time over all primitives.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from smallvcm_tpu.core.vec3 import V3
from smallvcm_tpu.ops.intersect import BIG_DIST, intersect, occluded
from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

N_RAYS = 2048


def _v3np(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)],
                    axis=-1).astype(np.float64)


def _oracle(scene, org, d):
    """[N] closest distance (inf on miss) and [N, P] per-primitive
    distances, float64."""
    p0, p1, p2 = (_v3np(scene.tri_p0), _v3np(scene.tri_p1),
                  _v3np(scene.tri_p2))
    nrm = _v3np(scene.tri_normal)
    o = org[:, None, :]
    dd = d[:, None, :]
    ao, bo, co = p0[None] - o, p1[None] - o, p2[None] - o
    v0 = np.sum(np.cross(co, bo) * dd, -1)
    v1 = np.sum(np.cross(bo, ao) * dd, -1)
    v2 = np.sum(np.cross(ao, co) * dd, -1)
    inside = ((v0 < 0) & (v1 < 0) & (v2 < 0)) | (
        (v0 >= 0) & (v1 >= 0) & (v2 >= 0))
    denom = np.sum(nrm[None] * dd, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_tri = np.sum(nrm[None] * ao, -1) / denom
    t_tri = np.where(inside & (denom != 0) & (t_tri > 0), t_tri, np.inf)

    c = _v3np(scene.sph_center)
    r = np.asarray(scene.sph_radius, np.float64)
    oc = o - c[None]
    a = np.sum(dd * dd, -1)
    b = 2.0 * np.sum(dd * oc, -1)
    cc = np.sum(oc * oc, -1) - r[None] ** 2
    disc = b * b - 4 * a * cc
    sq = np.sqrt(np.maximum(disc, 0.0))
    q = np.where(b < 0, (-b - sq) / 2, (-b + sq) / 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ta, tb = q / a, cc / q
    t0, t1 = np.minimum(ta, tb), np.maximum(ta, tb)
    t_sph = np.where(disc >= 0,
                     np.where(t0 > 0, t0, np.where(t1 > 0, t1, np.inf)),
                     np.inf)
    all_t = np.concatenate([t_tri, t_sph], axis=1)
    return all_t.min(axis=1), all_t


def _rays(scene, seed, n=N_RAYS):
    """Origins inside the box (inner 80% of the triangles' bounds),
    directions uniform on the sphere."""
    pts = np.concatenate([_v3np(scene.tri_p0), _v3np(scene.tri_p1),
                          _v3np(scene.tri_p2)])
    lo, hi = pts.min(0), pts.max(0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * 0.8
    rng = np.random.default_rng(seed)
    org = mid + half * rng.uniform(-1, 1, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _as_v3(a):
    return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
              jnp.asarray(a[:, 2]))


@pytest.mark.parametrize("scene_id", range(4))
def test_closest_hit_matches_float64_oracle(scene_id):
    scene = load_cornell_box((16, 16), SCENE_CONFIGS[scene_id])
    org, d = _rays(scene, scene_id)
    hit = intersect(scene, _as_v3(org), _as_v3(d))
    want, all_t = _oracle(scene, org.astype(np.float64),
                          d.astype(np.float64))

    got_hit = np.asarray(hit.hit)
    np.testing.assert_array_equal(got_hit, np.isfinite(want))
    got_t = np.asarray(hit.dist)
    np.testing.assert_allclose(got_t[got_hit], want[got_hit], rtol=1e-4,
                               atol=1e-4)
    assert (got_t[~got_hit] >= BIG_DIST).all()

    # The winning primitive: any primitive tied with the oracle's closest
    # hit is a right answer (a ray through the shared edge of a quad's two
    # triangles hits both at the same distance).
    prim = np.asarray(hit.prim)
    assert (prim[~got_hit] == -1).all()
    rows = np.nonzero(got_hit)[0]
    tied = all_t[rows] <= want[rows, None] * (1 + 1e-4) + 1e-4
    assert tied[np.arange(rows.size), prim[rows]].all()
    # Most rays have a unique winner; there the ids must agree exactly.
    unique = tied.sum(axis=1) == 1
    assert unique.mean() > 0.9
    np.testing.assert_array_equal(
        prim[rows][unique], np.argmin(all_t[rows], axis=1)[unique])


def test_occluded_agrees_with_intersect():
    """A shadow ray of length ``dist`` is blocked exactly when the closest
    hit from the EPS_RAY-offset origin lies before dist - 2*EPS_RAY
    (scene.hxx:72-85)."""
    from smallvcm_tpu.core.vecmath import EPS_RAY

    scene = load_cornell_box((16, 16), SCENE_CONFIGS[0])
    org, d = _rays(scene, 7)
    dist = np.random.default_rng(8).uniform(0.01, 3.0, N_RAYS).astype(
        np.float32)
    o, dv = _as_v3(org), _as_v3(d)
    blocked = np.asarray(occluded(scene, o, dv, jnp.asarray(dist)))
    hit = intersect(scene, o + dv * EPS_RAY, dv)
    want = np.asarray(hit.dist) < dist - 2.0 * EPS_RAY
    np.testing.assert_array_equal(blocked, want)
    assert 0.05 < blocked.mean() < 0.95   # both outcomes exercised
