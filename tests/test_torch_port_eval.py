"""The port's eval entry point (``cli.main_eval``, ``train.py --eval``)
against the JAX package's, on the CPU in fp32:

- ``main_eval`` at ``configs/tiny_smoke.yaml`` with ``pretrained_model_path``
  a directory written by JAX's ``save_pipeline`` (tiny weights,
  ``mixed_precision: "no"``, ``attn_impl`` unset, so ``"xla"`` on both
  sides) and the noise JAX draws for ``PRNGKey(0)`` handed to the port's
  ``run_validation``: the video within ``test_torch_port_pipeline.py``'s
  2e-4, ``latent_motion_score`` within 1e-4 of its value (fp32 noise of
  the latents, ~1e-5 of their largest value, summed over 3 frame pairs),
  ``motion_precision`` equal;
- ``calculate_motion_precision`` / ``get_moved_area_mask`` on seeded frames
  equal to JAX's, with and without JAX's native helper;
- the sample, its sidecar and the mask written under JAX's names;
- ``main_eval`` with ``pab:`` (PAB step caching, 6 steps) against JAX's;
- a run (eval or training) asked for on a card that is absent raises.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_tiny_models, n, save_jax_pipeline, t

VIDEO_ATOL, SCORE_RTOL = 2e-4, 1e-4
CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "tiny_smoke.yaml")


def _capture(monkeypatch, cls):
    """Record each ``cls.animate_image`` call's (video, latents) as numpy."""
    seen = []
    orig = cls.animate_image

    def recorded(self, *args, **kw):
        video, latents = orig(self, *args, **kw)
        seen.append((n(video), n(latents)))
        return video, latents

    monkeypatch.setattr(cls, "animate_image", recorded)
    return seen


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    return save_jax_pipeline(jax_tiny_models(), tmp_path_factory.mktemp("jax_pipeline"))


@pytest.fixture(scope="module")
def jax_eval(tiny_dir, tmp_path_factory):
    from animate_anything_tpu.cli import main_eval
    from animate_anything_tpu.core.config import load_config
    from animate_anything_tpu.pipelines import LatentToVideoPipeline

    out = tmp_path_factory.mktemp("jax_out")
    cfg = load_config(CONFIG, [f"pretrained_model_path={tiny_dir}", f"output_dir={out}"])
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp, LatentToVideoPipeline)
        with pytest.warns(UserWarning, match="tokenizer"):
            metrics = main_eval(**cfg.to_dict())
    (video, latents), = seen
    return cfg, metrics, video, latents


@pytest.fixture(scope="module")
def port_eval(tiny_dir, jax_eval, tmp_path_factory):
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    cfg, _, _, latents = jax_eval
    noise = jax.random.normal(jax.random.PRNGKey(0), latents.shape, jnp.float32)
    out = tmp_path_factory.mktemp("port_out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "run_validation",
                   functools.partial(cli.run_validation, noise=t(np.asarray(noise))))
        seen = _capture(mp, LatentToVideoPipeline)
        with pytest.warns(UserWarning, match="tokenizer"):
            metrics = cli.main_eval(device="cpu", **dict(cfg.to_dict(), output_dir=str(out)))
    (video, got_latents), = seen
    return metrics, video, got_latents


def test_main_eval_video_matches_jax(jax_eval, port_eval):
    _, _, want, _ = jax_eval
    _, got, _ = port_eval
    assert got.shape == want.shape == (1, 4, 32, 32, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=VIDEO_ATOL)


def test_main_eval_metrics_match_jax(jax_eval, port_eval):
    _, want, _, want_latents = jax_eval
    got, _, got_latents = port_eval
    assert set(got) == set(want) == {"sample_path", "motion_precision", "latent_motion_score",
                                     "mean_motion_precision"}
    np.testing.assert_allclose(got["latent_motion_score"], want["latent_motion_score"],
                               rtol=SCORE_RTOL)
    assert got["motion_precision"] == want["motion_precision"]
    assert got["mean_motion_precision"] == want["mean_motion_precision"]
    assert os.path.isfile(got["sample_path"]) and got["sample_path"].endswith(".gif")
    np.testing.assert_allclose(got_latents, want_latents,
                               atol=2e-5 * np.abs(want_latents).max())


def _moving_frames(seed: int, f: int = 6, hw: int = 48, step: int = 1) -> np.ndarray:
    """A random still with two squares that move, one of them out of the
    mask, and noise below the thresholds; every channel a multiple of
    ``step``."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (hw, hw, 3)).astype(np.int32)
    frames = []
    for i in range(f):
        fr = base + r.integers(-3, 4, base.shape)
        fr[5:13, 4 + 3 * i:12 + 3 * i] = [255, 30, 30]
        fr[30:36, 30 - i:36 - i] = [20, 200, 240]
        frames.append(np.clip(fr, 0, 255) // step * step)
    return np.stack(frames).astype(np.uint8)


def _precision_mask(frames):
    mask = np.zeros(frames.shape[1:3], np.uint8)
    mask[:20, :] = 255
    return mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moved_area_mask_and_motion_precision_match_jax_numpy_path(seed, monkeypatch):
    from animate_anything_tpu.metrics import motion as jax_motion
    from animate_anything_tpu_torch.metrics import motion

    frames, mask = _moving_frames(seed), _precision_mask(_moving_frames(seed))
    for move_th, th in ((5.0, -1.0), (20, 0), (20, 30)):
        got = motion.get_moved_area_mask(frames, move_th=move_th, th=th, use_native=False)
        want = jax_motion.get_moved_area_mask(frames, move_th=move_th, th=th, use_native=False)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    for module in (motion, jax_motion):
        monkeypatch.setattr(module, "get_moved_area_mask", functools.partial(
            module.get_moved_area_mask, use_native=False))
    precision = motion.calculate_motion_precision(frames, mask)
    assert 0.0 < precision < 1.0
    assert precision == jax_motion.calculate_motion_precision(frames, mask)
    still = np.repeat(frames[:1], 4, axis=0)
    assert motion.calculate_motion_precision(still, mask) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moved_area_mask_and_motion_precision_match_jax_native_path(seed):
    """JAX's default (its native helper where built) on frames whose channels
    are multiples of 7: no gray difference then lies at a threshold (3·5 and
    3·20 are no multiples of 7), where the helper's fp32 gray and the numpy
    path's fp64 gray answer differently (pinned below)."""
    from animate_anything_tpu.metrics import motion as jax_motion
    from animate_anything_tpu_torch.metrics import motion

    frames = _moving_frames(seed, step=7)
    mask = _precision_mask(frames)
    for move_th, th in ((5.0, -1.0), (20, 0), (20, 30)):
        np.testing.assert_array_equal(
            motion.get_moved_area_mask(frames, move_th=move_th, th=th),
            jax_motion.get_moved_area_mask(frames, move_th=move_th, th=th))
    precision = motion.calculate_motion_precision(frames, mask)
    assert 0.0 < precision < 1.0
    assert precision == jax_motion.calculate_motion_precision(frames, mask)


def test_moved_area_mask_at_a_threshold_tie_follows_jax_numpy_path():
    """A gray step of exactly 5 from sums 100 → 85: fp64 reads 5.000000000000004
    (moved), fp32 4.999998 (not moved). JAX's numpy path and the port's say
    moved; JAX's native helper and the port's copy of it, where built, say
    not (ROADMAP queue 3)."""
    from animate_anything_tpu.data import native
    from animate_anything_tpu.metrics import motion as jax_motion
    from animate_anything_tpu_torch.data import native as port_native
    from animate_anything_tpu_torch.metrics import motion

    frames = np.zeros((2, 5, 5, 3), np.uint8)
    frames[0, 2, 2] = (34, 33, 33)
    frames[1, 2, 2] = (29, 28, 28)
    got = motion.get_moved_area_mask(frames, move_th=5.0, th=0, use_native=False)
    np.testing.assert_array_equal(
        got, jax_motion.get_moved_area_mask(frames, move_th=5.0, th=0, use_native=False))
    assert (got == 255).all()
    helper = native.moved_area_mask(frames, 5.0, 0)
    if helper is not None:
        assert (helper == 0).all()
    assert port_native.available()
    np.testing.assert_array_equal(motion.get_moved_area_mask(frames, move_th=5.0, th=0),
                                  np.zeros((5, 5), np.uint8))


def test_main_eval_writes_the_files_jax_writes(jax_eval, port_eval):
    """The sample gif (one frame each), its mp4 sidecar (or the gif where
    imageio is absent) and the mask jpg, under the same names as JAX's."""
    from PIL import Image

    cfg, want, _, _ = jax_eval
    got, video, _ = port_eval
    jax_dir = os.path.dirname(want["sample_path"])
    port_dir = os.path.dirname(got["sample_path"])
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert os.path.basename(got["sample_path"]) == os.path.basename(want["sample_path"])
    with Image.open(got["sample_path"]) as gif:
        assert gif.n_frames == video.shape[1] and gif.size == video.shape[3:1:-1]
    with Image.open(os.path.join(port_dir, "step_0_mask.jpg")) as mask:
        with Image.open(os.path.join(jax_dir, "step_0_mask.jpg")) as want_mask:
            np.testing.assert_array_equal(np.asarray(mask), np.asarray(want_mask))


PAB = {"spatial_rate": 2, "temporal_rate": 3, "warmup": 1, "tail": 1}


@pytest.fixture(scope="module")
def pab_evals(tiny_dir, tmp_path_factory):
    """Both sides' ``main_eval`` with ``pab:`` (6 steps: both flags fire),
    JAX's start noise handed to the port as in ``port_eval``."""
    from animate_anything_tpu.cli import main_eval
    from animate_anything_tpu.core.config import load_config
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    cfg = load_config(CONFIG, [f"pretrained_model_path={tiny_dir}",
                               "validation_data.num_inference_steps=6"]).to_dict()
    cfg["pab"] = PAB
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp, JaxPipeline)
        with pytest.warns(UserWarning, match="tokenizer"):
            want = main_eval(**dict(cfg, output_dir=str(tmp_path_factory.mktemp("jax_pab"))))
    (want_video, want_latents), = seen
    noise = jax.random.normal(jax.random.PRNGKey(0), want_latents.shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "run_validation",
                   functools.partial(cli.run_validation, noise=t(np.asarray(noise))))
        seen = _capture(mp, LatentToVideoPipeline)
        with pytest.warns(UserWarning, match="tokenizer"):
            got = cli.main_eval(device="cpu", **dict(
                cfg, output_dir=str(tmp_path_factory.mktemp("port_pab"))))
    (got_video, got_latents), = seen
    return want, want_video, want_latents, got, got_video, got_latents


def test_main_eval_with_pab_matches_jax(pab_evals):
    """``main_eval`` takes ``pab:`` through to the pipeline as JAX's does: the
    video, latents and motion score within the exact run's tolerances of
    JAX's."""
    want, want_video, want_latents, got, got_video, got_latents = pab_evals
    assert got_video.shape == want_video.shape == (1, 4, 32, 32, 3)
    np.testing.assert_allclose(got_video, want_video, atol=VIDEO_ATOL)
    np.testing.assert_allclose(got_latents, want_latents,
                               atol=2e-5 * np.abs(want_latents).max())
    np.testing.assert_allclose(got["latent_motion_score"], want["latent_motion_score"],
                               rtol=SCORE_RTOL)


def test_cli_eval_runs_and_training_raises(tmp_path, capsys):
    from animate_anything_tpu_torch.cli import cli

    cli(["--config", CONFIG, "--eval", "--device", "cpu", f"output_dir={tmp_path}",
         "validation_data.num_inference_steps=2"])
    assert "latent_motion_score" in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "samples" / "step_0.gif")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["--config", CONFIG, f"output_dir={tmp_path / 'train'}"])
    assert not os.path.exists(tmp_path / "train")


def test_main_eval_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    from animate_anything_tpu_torch.cli import main_eval
    from animate_anything_tpu_torch.core.config import load_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = load_config(CONFIG, [f"output_dir={tmp_path}"]).to_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        main_eval(**cfg)
