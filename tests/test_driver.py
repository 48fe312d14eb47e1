"""Block-driver bookkeeping: the cap ladder, block sizes, the caps sidecar."""

import pytest

from smallvcm_tpu import render as R
from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box


@pytest.mark.parametrize("needed", [1, 1024, 1025, 5000, 123457, 9_000_000])
def test_bucket_covers_need_with_bounded_padding(needed):
    n = 4096
    cap = R._bucket(needed, n) * n
    assert cap >= max(needed, 1024)
    # m * 2^e with m in 4..8: the next rung is at most 5/4 of the need
    assert cap <= 1.25 * max(needed, 1024) + 1
    assert cap == int(cap)        # exact, so jit static args repeat


@pytest.mark.parametrize("alg,res,want", [
    ("pt", 512, 64), ("el", 1024, 16), ("vcm", 512, 8), ("vcm", 1024, 2),
    ("bpm", 2048, 1),
])
def test_auto_block_size_scales_with_resolution(alg, res, want):
    cfg = R.RenderConfig(algorithm=alg, resolution=(res, res))
    assert R.auto_block_size(cfg, alg) == want
    cfg.block_size = 3
    assert R.auto_block_size(cfg, alg) == 3


def test_caps_sidecar_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("SMALLVCM_TPU_CACHE", str(tmp_path))
    scene = load_cornell_box((16, 16), SCENE_CONFIGS[0])
    cfg = R.RenderConfig(algorithm="vcm", resolution=(16, 16))
    key = R._caps_key(scene, cfg, "vcm")
    caps = dict(pair_factor=5.0, photon_factor=1.25, query_factor=2.5)
    R._save_cached_caps(key, caps)
    assert R._load_cached_caps(key) == caps
    # The key separates seeds: caps sized under one rng stream are not
    # reused under another.
    other = R.RenderConfig(algorithm="vcm", resolution=(16, 16), base_seed=7)
    assert R._load_cached_caps(R._caps_key(scene, other, "vcm")) is None
    R._ensure_merge_caps(scene, cfg, "vcm", True, False)
    assert cfg.merge_caps_frozen and cfg.pair_factor == 5.0
