"""``main_eval`` with a saved LoRA adapter, the port's against the JAX
package's, on the CPU at ``configs/tiny_smoke.yaml`` (tiny models, fp32,
``attn_impl`` unset: ``"xla"`` on both sides), from a JAX-saved pipeline:

- a JAX-saved UNet adapter and its ``.text_encoder.safetensors`` sibling
  (found beside it, as JAX finds it) merged before the cast; the video
  against JAX's ``main_eval`` with JAX's noise within
  ``test_torch_port_eval.py``'s 2e-4, the motion precision equal, and the
  video unlike the unadapted one;
- ``eval_models``: the text sibling merged, the UNet's convs untouched (the
  adapter targets dense kernels), the bf16 policy's weights the cast of the
  fp32 merge.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_tiny_models, save_jax_pipeline, t

CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "tiny_smoke.yaml")
VIDEO_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these many tiny CPU ops: beside the other
    test workers, a thread pool per op costs more than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_adapter(tmp_path_factory):
    """A JAX-saved UNet adapter with its text-encoder sibling (numpy-drawn,
    non-zero ``up``) beside a JAX-saved tiny pipeline."""
    from animate_anything_tpu.models.lora import LoraConfig, init_lora_params, save_lora

    jm = jax_tiny_models()
    d = tmp_path_factory.mktemp("jax_lora")
    pipe = save_jax_pipeline(jm, d / "pipeline")
    r = np.random.default_rng(4)
    for prefix, params, cfg, name in (
            ("unet", jm["unet_params"], LoraConfig(rank=4, targets=("UNet3DConditionModel",)),
             "adapter.safetensors"),
            ("text_encoder", jm["text_params"], LoraConfig(rank=2, alpha=4.0,
                                                           targets=("CLIPEncoderLayer",)),
             "adapter.text_encoder.safetensors")):
        lora = {p: {k: (0.05 * r.standard_normal(v.shape)).astype(np.float32)
                    for k, v in ab.items()}
                for p, ab in init_lora_params(jax.random.PRNGKey(0), params, cfg).items()}
        save_lora(str(d / name), lora, cfg, prefix=prefix)
    return pipe, str(d / "adapter.safetensors")


def test_main_eval_with_a_jax_saved_adapter_matches_jax(jax_adapter, tmp_path):
    from animate_anything_tpu.cli import main_eval as jax_main_eval
    from animate_anything_tpu.core.config import load_config
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipe
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from test_torch_port_eval import _capture

    pipe, adapter = jax_adapter
    cfg = load_config(CONFIG, [f"pretrained_model_path={pipe}", f"output_dir={tmp_path / 'j'}",
                               f"lora_path={adapter}"]).to_dict()
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp, JaxPipe)
        with pytest.warns(UserWarning, match="tokenizer"):
            want = jax_main_eval(**cfg)
    (want_video, latents), = seen
    noise = jax.random.normal(jax.random.PRNGKey(0), latents.shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "run_validation",
                   functools.partial(cli.run_validation, noise=t(np.asarray(noise))))
        seen = _capture(mp, LatentToVideoPipeline)
        with pytest.warns(UserWarning, match="tokenizer"):
            got = cli.main_eval(device="cpu", **dict(cfg, output_dir=str(tmp_path / "p")))
    (video, _), = seen
    assert video.shape == want_video.shape and np.isfinite(video).all()
    np.testing.assert_allclose(video, want_video, atol=VIDEO_ATOL)
    assert got["motion_precision"] == want["motion_precision"]
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp, LatentToVideoPipeline)
        with pytest.warns(UserWarning, match="tokenizer"):
            cli.main_eval(device="cpu", **dict(cfg, output_dir=str(tmp_path / "b"),
                                               lora_path=None))
    (base, _), = seen
    assert np.abs(base - video).max() > 10 * VIDEO_ATOL


def test_eval_models_merges_the_text_sibling_and_casts_after(jax_adapter):
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.core.config import Config, load_config

    pipe, adapter = jax_adapter
    cfg = load_config(CONFIG, [f"pretrained_model_path={pipe}"])
    with pytest.warns(UserWarning, match="tokenizer"):
        base = cli.eval_models(cfg, "cpu")
        merged = cli.eval_models(Config(dict(cfg, lora_path=adapter)), "cpu")
        bf16 = cli.eval_models(Config(dict(cfg, lora_path=adapter, mixed_precision="bf16")),
                               "cpu")
    name = "text_model.encoder.layers.0.self_attn.q_proj.weight"
    assert not torch.equal(base["text"].state_dict()[name], merged["text"].state_dict()[name])
    assert torch.equal(base["unet"].state_dict()["conv_out.weight"],
                       merged["unet"].state_dict()["conv_out.weight"])
    want = merged["unet"].state_dict()
    for k, v in bf16["unet"].state_dict().items():
        assert torch.equal(v, want[k].to(v.dtype)), k
