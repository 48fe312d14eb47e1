"""CLI behavior and checkpoint/resume exactness."""

import os
import subprocess
import sys

import numpy as np
import pytest

from smallvcm_tpu import checkpoint
from smallvcm_tpu.render import RenderConfig
from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box
from smallvcm_tpu.cli import build_default_filename, make_parser


class TestCliParsing:
    def test_defaults_match_reference(self):
        """config.hxx:228-241 defaults."""
        args = make_parser().parse_args([])
        assert args.scene_id == 0
        assert args.iterations == 1
        assert args.max_time == -1.0
        assert args.seed == 1234
        assert args.max_path_length == 10
        assert args.min_path_length == 0
        assert tuple(args.resolution) == (512, 512)
        assert args.radius_factor == pytest.approx(0.003)
        assert args.radius_alpha == pytest.approx(0.75)

    def test_default_filenames(self):
        """config.hxx:153-174 names like gbs_s_vcm.bmp."""
        assert build_default_filename(SCENE_CONFIGS[0], "vcm") == "ggbs_s_vcm.bmp"
        assert build_default_filename(SCENE_CONFIGS[1], "el") == "gglm_c_el.bmp"
        assert build_default_filename(SCENE_CONFIGS[2], "pt") == "ggbs_p_pt.bmp"
        assert build_default_filename(SCENE_CONFIGS[3], "bpt") == "ggbs_b_bpt.bmp"

    def test_cli_end_to_end(self, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "smallvcm_tpu.cli", "-s", "1", "-a", "el",
             "-i", "1", "--resolution", "32", "32", "-o", "t.bmp"],
            cwd=str(tmp_path), capture_output=True, text=True,
            # The child renders on the CPU, like the rest of the suite.
            env={
                **os.environ,
                "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))
                + os.pathsep + os.environ.get("PYTHONPATH", ""),
            },
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert (tmp_path / "t.bmp").exists()
        assert "Scene:" in out.stdout and "done in" in out.stdout


class TestCheckpoint:
    def test_resume_is_exact(self, tmp_path):
        scene = load_cornell_box((32, 32), SCENE_CONFIGS[1])
        ckpt = str(tmp_path / "state.npz")

        cfg = RenderConfig(algorithm="pt", iterations=4, resolution=(32, 32))
        full, _, iters = checkpoint.render_resumable(scene, cfg)
        assert iters == 4

        # Render 2, checkpoint, then resume to 4 — must match bit-for-bit.
        cfg2 = RenderConfig(algorithm="pt", iterations=2, resolution=(32, 32))
        img2, _, _ = checkpoint.render_resumable(
            scene, cfg2, checkpoint_path=ckpt, checkpoint_every=2
        )
        assert os.path.exists(ckpt)

        cfg4 = RenderConfig(algorithm="pt", iterations=4, resolution=(32, 32))
        resumed, _, _ = checkpoint.render_resumable(
            scene, cfg4, checkpoint_path=ckpt
        )
        np.testing.assert_array_equal(np.asarray(full), np.asarray(resumed))

    def test_checkpoint_roundtrip(self, tmp_path):
        import jax.numpy as jnp

        fb = jnp.arange(48.0).reshape(4, 4, 3)
        p = str(tmp_path / "c.npz")
        checkpoint.save_checkpoint(p, fb, 7, 1234, dict(algorithm="vcm"))
        fb2, it, seed, meta = checkpoint.load_checkpoint(p)
        np.testing.assert_array_equal(np.asarray(fb), np.asarray(fb2))
        assert it == 7 and seed == 1234 and meta["algorithm"] == "vcm"
