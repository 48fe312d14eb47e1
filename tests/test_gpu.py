"""Small compiled checks that need a GPU.

Run on a GPU host with:  JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
Elsewhere every case skips through the ``gpu`` fixture (conftest.py).
"""

import numpy as np
import jax
import pytest

from smallvcm_tpu.algorithms import vcm
from smallvcm_tpu.render import RenderConfig, render
from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

from .test_merge_stage import _dense_merge, _merge_inputs

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("ppm", [False, True])
def test_merge_stage_matches_dense_on_gpu(gpu, ppm):
    """The merge's sorts and scatter-adds as the GPU compiles them."""
    scene, misc, queries, light_verts, n = _merge_inputs(4, 30.0, res=16)
    got, overflow, _ = vcm.merge_stage(
        scene, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=64 * n, ppm=ppm, max_path_length=7, min_path_length=0,
        photon_cap=5 * n, query_cap=4 * n, n_paths=n,
    )
    assert int(overflow) == 0
    want = _dense_merge(scene, misc, queries, light_verts, ppm, 7, 0, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("alg", ["el", "pt", "lt", "ppm", "bpm", "bpt",
                                 "vcm"])
def test_render_64(gpu, alg):
    scene = load_cornell_box((64, 64), SCENE_CONFIGS[0])
    img, _, iters = render(scene, RenderConfig(algorithm=alg, iterations=2,
                                               resolution=(64, 64)))
    img = np.asarray(img)
    assert iters == 2 and img.shape == (64, 64, 3)
    assert np.isfinite(img).all() and img.mean() > 0


def test_gpu_render_matches_cpu_64(gpu):
    """Same seed on both backends: the images agree but for the few paths
    whose float rounding differs enough to change a sampling decision."""
    res = (64, 64)
    scene = load_cornell_box(res, SCENE_CONFIGS[0])
    g = np.asarray(render(scene, RenderConfig(algorithm="vcm",
                                              resolution=res))[0])
    with jax.default_device(jax.devices("cpu")[0]):
        scene_c = load_cornell_box(res, SCENE_CONFIGS[0])
        c = np.asarray(render(scene_c, RenderConfig(algorithm="vcm",
                                                    resolution=res))[0])
    close = np.abs(g - c) <= 1e-4 + 1e-4 * np.abs(c)
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * c.mean()
