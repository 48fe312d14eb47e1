"""Merge-stage oracle: the compact/sort/expand/survivor pipeline must equal
a dense all-pairs evaluation built from the same BSDF/MIS primitives.

The production merge (algorithms/vcm.py::merge_stage) moves data through
photon/query compaction, a radix cell sort, segment-carry pair expansion,
and sort-based survivor compaction — lots of index machinery worth pinning
against a trivially-correct O(Q*M) reference (RangeQuery::Process,
vertexcm.hxx:130-169, evaluated densely)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smallvcm_tpu.algorithms import vcm
from smallvcm_tpu.core.vec3 import V3, max_gt_zero, v3_where
from smallvcm_tpu.ops import bsdf as bsdf_ops
from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box


def _random_vertices(key, l, n, lo, hi, n_mats):
    ks = jax.random.split(key, 8)
    unit = lambda k: _normalize3(jax.random.normal(k, (3, l, n), jnp.float32))
    pos = jax.random.uniform(ks[0], (3, l, n), jnp.float32, lo, hi)
    ind = unit(ks[1])
    nrm = unit(ks[2])
    thr = jax.random.uniform(ks[3], (3, l, n), jnp.float32, 0.1, 1.0)
    return vcm.StoredVertices(
        position=V3(*pos), in_dir=V3(*ind), normal=V3(*nrm),
        throughput=V3(*thr),
        mat_id=jax.random.randint(ks[4], (l, n), 0, n_mats, jnp.int32),
        d_vcm=jax.random.uniform(ks[5], (l, n), jnp.float32, 0.0, 2.0),
        d_vc=jnp.zeros((l, n), jnp.float32),
        d_vm=jax.random.uniform(ks[6], (l, n), jnp.float32, 0.0, 2.0),
        valid=jax.random.uniform(ks[7], (l, n)) < 0.6,
    )


def _normalize3(a):
    return a / jnp.linalg.norm(a, axis=0, keepdims=True)


def _dense_merge(scene, misc, queries, light_verts, ppm, max_pl, min_pl, n):
    """All (query, photon) pairs, dense — no grids, no compaction."""
    lq, nq = queries.valid.shape
    ll, np_ = light_verts.valid.shape
    flat = lambda a: a.reshape((-1,))
    flatv = lambda v: V3(flat(v.x), flat(v.y), flat(v.z))
    q = jax.tree.map(lambda a: a.reshape((-1,)), queries)
    p = jax.tree.map(lambda a: a.reshape((-1,)), light_verts)
    mq, mp = lq * nq, ll * np_

    exp_q = lambda a: jnp.repeat(a, mp)          # [mq*mp]
    exp_p = lambda a: jnp.tile(a, mq)
    ev_q = lambda v: V3(exp_q(v.x), exp_q(v.y), exp_q(v.z))
    ev_p = lambda v: V3(exp_p(v.x), exp_p(v.y), exp_p(v.z))

    d = ev_q(q.position) - ev_p(p.position)
    from smallvcm_tpu.core.vec3 import len_sqr
    ok = (
        exp_q(q.valid) & exp_p(p.valid)
        & (len_sqr(d) <= misc.radius_sqr)
    )
    q_len = exp_q(jnp.repeat(jnp.arange(lq) + 1, nq))
    p_len = exp_p(jnp.repeat(jnp.arange(ll) + 1, np_))
    total = q_len + p_len
    ok = ok & (total <= max_pl) & (total >= min_pl)

    cam_b = bsdf_ops.setup(
        scene.materials, ev_q(q.in_dir), ev_q(q.normal), exp_q(q.mat_id), ok
    )
    ph_b = bsdf_ops.setup(
        scene.materials, ev_p(p.in_dir), ev_p(p.normal), exp_p(p.mat_id), ok
    )
    light_dir = -ev_p(p.in_dir)
    factor, _, dir_pdf_w, rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, cam_b, light_dir
    )
    ok = ok & max_gt_zero(factor)
    dir_pdf_w = dir_pdf_w * cam_b.cont_prob
    rev_pdf_w = rev_pdf_w * ph_b.cont_prob
    w_light = exp_p(p.d_vcm) * misc.mis_vc_weight + \
        exp_p(p.d_vm) * dir_pdf_w
    w_camera = exp_q(q.d_vcm) * misc.mis_vc_weight + \
        exp_q(q.d_vm) * rev_pdf_w
    mis = jnp.ones_like(w_light) if ppm else 1.0 / (w_light + 1.0 + w_camera)
    contrib = v3_where(ok, factor * ev_p(p.throughput) * mis, 0.0)

    per_q = V3(
        jnp.sum(contrib.x.reshape(mq, mp), 1),
        jnp.sum(contrib.y.reshape(mq, mp), 1),
        jnp.sum(contrib.z.reshape(mq, mp), 1),
    )
    per_q = per_q * flatv(queries.throughput) * misc.vm_normalization
    path = jnp.tile(jnp.arange(nq), lq)
    z = jnp.zeros((n,), jnp.float32)
    return V3(
        z.at[path].add(per_q.x), z.at[path].add(per_q.y),
        z.at[path].add(per_q.z),
    )


@pytest.mark.parametrize("ppm", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_stage_matches_dense(ppm, seed):
    res = 8
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1])
    misc = vcm.compute_misc(scene, 0, n, 0.05, 0.75, True, True)

    key = jax.random.PRNGKey(seed)
    kq, kp = jax.random.split(key)
    # Positions spread over a box ~30 radii wide: plenty of in-radius pairs
    # plus plenty of rejections.
    span = float(misc.radius) * 30.0
    queries = _random_vertices(kq, 4, n, 0.0, span, 9)
    light_verts = _random_vertices(kp, 5, n, 0.0, span, 9)

    got, overflow, stats = vcm.merge_stage(
        scene, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=64 * n, ppm=ppm, max_path_length=7, min_path_length=0,
        photon_cap=5 * n, query_cap=4 * n, n_paths=n,
    )
    assert int(overflow) == 0
    assert int(stats[0]) > 0  # candidate pairs
    want = _dense_merge(scene, misc, queries, light_verts, ppm, 7, 0, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=2e-5, atol=1e-7
        )


def test_merge_stage_overflow_reported():
    """Pair overflow must be counted, never silently dropped."""
    res = 8
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1])
    misc = vcm.compute_misc(scene, 0, n, 0.05, 0.75, True, True)
    key = jax.random.PRNGKey(2)
    kq, kp = jax.random.split(key)
    span = float(misc.radius) * 4.0  # dense clump -> many pairs
    queries = _random_vertices(kq, 4, n, 0.0, span, 9)
    light_verts = _random_vertices(kp, 5, n, 0.0, span, 9)
    _, overflow, stats = vcm.merge_stage(
        scene, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=8, ppm=False, max_path_length=9, min_path_length=0,
        photon_cap=5 * n, query_cap=4 * n, n_paths=n,
    )
    # The per-chunk cap floors at 1024 rows; anything beyond must be counted.
    assert int(stats[0]) > 1024
    assert int(overflow) >= int(stats[0]) - 1024


def _merge_inputs(seed, span_radii, res=8):
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1])
    misc = vcm.compute_misc(scene, 0, n, 0.05, 0.75, True, True)
    kq, kp = jax.random.split(jax.random.PRNGKey(seed))
    span = float(misc.radius) * span_radii
    queries = _random_vertices(kq, 4, n, 0.0, span, 9)
    light_verts = _random_vertices(kp, 5, n, 0.0, span, 9)
    return scene, misc, queries, light_verts, n


@pytest.mark.parametrize("ppm", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_merge_matches_dense(ppm, seed):
    """The chunked query loop (merge_chunks > 1, per-chunk pair caps with
    slack for an uneven split) equals the dense all-pairs oracle."""
    scene, misc, queries, light_verts, n = _merge_inputs(seed + 10, 30.0)
    got, overflow, stats = vcm.merge_stage(
        scene, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=64 * n, ppm=ppm, max_path_length=7, min_path_length=0,
        photon_cap=5 * n, query_cap=4 * n, n_paths=n, merge_chunks=4,
    )
    assert int(overflow) == 0
    assert int(stats[0]) > 0
    want = _dense_merge(scene, misc, queries, light_verts, ppm, 7, 0, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=2e-5, atol=1e-7
        )


def test_min_path_length_window_matches_dense():
    """The path-length window (vertexcm.hxx:132-135) with a lower bound."""
    scene, misc, queries, light_verts, n = _merge_inputs(5, 30.0)
    got, overflow, _ = vcm.merge_stage(
        scene, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=64 * n, ppm=False, max_path_length=8, min_path_length=5,
        photon_cap=5 * n, query_cap=4 * n, n_paths=n,
    )
    assert int(overflow) == 0
    want = _dense_merge(scene, misc, queries, light_verts, False, 8, 5, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=2e-5, atol=1e-7
        )


@pytest.mark.parametrize("side", ["photon", "query"])
def test_merge_stage_compaction_overflow_reported(side):
    """A photon or query compaction cap below the live count is reported
    as overflow (so the driver grows it and re-renders), with the live
    counts in stats."""
    scene, misc, queries, light_verts, n = _merge_inputs(2, 4.0)
    caps = dict(photon_cap=5 * n, query_cap=4 * n)
    caps[f"{side}_cap"] = 8
    _, overflow, stats = vcm.merge_stage(
        scene, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=64 * n, ppm=False, max_path_length=9, min_path_length=0,
        n_paths=n, **caps,
    )
    live = int(stats[1] if side == "photon" else stats[2])
    assert live > 8
    assert int(overflow) >= live - 8
