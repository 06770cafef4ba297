"""The port's text path against the JAX package's, on the CPU in fp32: the
CLIP text encoder, both tokenizers, and the 2-step image-to-video pipeline
driven by a prompt string.

- ``CLIPTextModel`` (tiny config) on the same ids, weights carried over by
  ``utils/convert.py::clip_text_state_dict`` with ``strict=True``; atol
  1e-5 (fp32 noise through two layers and the final LayerNorm).
- ``HashTokenizer`` and the BPE ``CLIPBPETokenizer`` (on the synthetic vocab
  of ``tests/test_tokenizer.py``) give JAX's ids exactly.
- ``animate_image(image, prompt)`` with the tiny UNet, VAE and CLIP text
  encoder and the hash tokenizer, on the fused temporal path on both sides
  (JAX's gate as it is, its fused block through its exact twin off the
  TPU), flash in interpret mode; tolerances as ``test_torch_port_pipeline``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, t

VIDEO_ATOL, LATENT_REL = 2e-4, 2e-5
FRAMES, STEPS, RES = 3, 2, 128
PROMPT = "A red Ball rolls across the table"


def test_causal_attention_matches_jax():
    from animate_anything_tpu_torch.ops.attention import attention

    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((2, 9, 2, 16)).astype(np.float32) for _ in range(3))
    want = jax.nn.dot_product_attention(q, k, v, is_causal=True)
    got = attention(t(q), t(k), t(v), is_causal=True)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_model_matches_jax(act):
    from animate_anything_tpu.models.clip_text import CLIPTextConfig as JaxCfg
    from animate_anything_tpu.models.clip_text import CLIPTextModel as JaxCLIP
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.utils.convert import clip_text_state_dict

    ids = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    jm = JaxCLIP(JaxCfg.tiny(hidden_act=act))
    p = jax_params(jm, ids)
    port = load_into(CLIPTextModel(CLIPTextConfig.tiny(hidden_act=act)), clip_text_state_dict(p))
    assert "text_model.encoder.layers.0.self_attn.q_proj.weight" in port.state_dict()
    with torch.no_grad():
        got = port(t(ids))
    assert got.shape == (2, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(jm.apply(p, ids)), atol=1e-5)


def test_init_clip_text_matches_flax_initialisers():
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.utils.convert import init_clip_text_

    cfg = CLIPTextConfig.tiny(vocab_size=4096, hidden_size=64)
    m = init_clip_text_(CLIPTextModel(cfg), torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in m.named_parameters()}
    tok = params["text_model.embeddings.token_embedding.weight"]      # N(0, 1/hidden)
    assert abs(float(tok.std()) * math.sqrt(64) - 1.0) < 0.02
    fc1 = params["text_model.encoder.layers.0.mlp.fc1.weight"]        # lecun normal, fan-in 64
    assert abs(float(fc1.std()) * math.sqrt(64) - 1.0) < 0.1
    assert all(float(p.abs().max()) == 0 for k, p in params.items() if k.endswith(".bias"))
    assert bool((params["text_model.final_layer_norm.weight"] == 1).all())


def test_hash_tokenizer_matches_jax():
    from animate_anything_tpu.models.factory import HashTokenizer as JaxHash
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    texts = [PROMPT, "", "one two three four five six seven eight nine ten eleven twelve"
             " thirteen fourteen fifteen sixteen"]
    for vocab, length in ((64, 16), (49408, 77)):
        want, got = JaxHash(vocab, length), HashTokenizer(vocab, length)
        np.testing.assert_array_equal(got(texts, padding="max_length", max_length=77).input_ids,
                                      want(texts, padding="max_length", max_length=77).input_ids)
        assert got.encode(PROMPT) == want.encode(PROMPT)


def test_bpe_tokenizer_matches_jax(tmp_path):
    from test_tokenizer import _write_assets

    from animate_anything_tpu.models.clip_tokenizer import CLIPBPETokenizer as JaxBPE
    from animate_anything_tpu_torch.models.clip_tokenizer import CLIPBPETokenizer

    vpath, mpath, _ = _write_assets(tmp_path)
    want, got = JaxBPE(vpath, mpath), CLIPBPETokenizer(vpath, mpath)
    texts = ["hello world", "The cat's hat", "HELLO Cat!!  of  the", "xy 42 &amp; w0rld", ""]
    for text in texts:
        assert got.encode(text) == want.encode(text)
        assert got.decode(got.encode(text)) == want.decode(want.encode(text))
    np.testing.assert_array_equal(
        got(texts, padding="max_length", max_length=12).input_ids,
        want(texts, padding="max_length", max_length=12).input_ids)


@pytest.fixture(scope="module")
def prompt_case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.clip_text import CLIPTextConfig as JaxTextCfg
    from animate_anything_tpu.models.clip_text import CLIPTextModel as JaxCLIP
    from animate_anything_tpu.models.factory import HashTokenizer as JaxHash
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline

    r = np.random.default_rng(0)
    h8 = RES // 8
    image = r.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    mask_img = np.where(r.random((RES, RES)) > 0.5, 255, 0).astype(np.uint8)
    jax_cfg = dict(motion_mask=True, motion_strength=True)
    z = np.zeros((1, 1, h8, h8, 4), np.float32)
    ctx = np.zeros((1, 16, 32), np.float32)
    uparams = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **jax_cfg)), z, np.int32(1), ctx,
                         z, z[..., :1], np.ones(1, np.float32))
    vae = JaxVAE(JaxVAECfg.tiny())
    vparams = jax_params(vae, jnp.zeros((1, RES, RES, 3)), seed=1)
    text = JaxCLIP(JaxTextCfg.tiny())
    tparams = jax_params(text, np.zeros((1, 16), np.int32), seed=2)
    pipe = JaxPipeline(JaxUNet(JaxCfg.tiny(attn_impl="pallas", **jax_cfg)), uparams, vae, vparams,
                       text_encoder=text, text_params=tparams, tokenizer=JaxHash(64, 16))
    key = jax.random.PRNGKey(11)
    with pltpu.force_tpu_interpret_mode():
        video, latents = pipe.animate_image(
            image, PROMPT, mask_img=mask_img, motion_strength=6.0, num_frames=FRAMES,
            num_inference_steps=STEPS, guidance_scale=9.0, rng=key)
    noise = jax.random.normal(key, (1, FRAMES, h8, h8, 4), jnp.float32)
    params = (uparams, vparams, tparams)
    return params, image, mask_img, np.asarray(noise), np.asarray(video), np.asarray(latents)


@pytest.fixture(scope="module")
def prompt_result(prompt_case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import (clip_text_state_dict,
                                                          unet3d_state_dict, vae_state_dict)

    (uparams, vparams, tparams), image, mask_img, noise, _, _ = prompt_case
    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True,
                                                            motion_strength=True)),
                     unet3d_state_dict(uparams))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams))
    text = load_into(CLIPTextModel(CLIPTextConfig.tiny()), clip_text_state_dict(tparams))
    pipe = LatentToVideoPipeline(unet, vae, text_encoder=text, tokenizer=HashTokenizer(64, 16))
    return pipe.animate_image(image, PROMPT, mask_img=mask_img, motion_strength=6.0,
                              num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0,
                              noise=t(noise))


def test_prompt_pipeline_latents_match_jax(prompt_case, prompt_result):
    want = prompt_case[5]
    _, latents = prompt_result
    assert latents.shape == want.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(n(latents), want, atol=LATENT_REL * np.abs(want).max())


def test_prompt_pipeline_video_matches_jax(prompt_case, prompt_result):
    want = prompt_case[4]
    video, _ = prompt_result
    assert video.shape == want.shape == (1, FRAMES, RES, RES, 3)
    assert np.isfinite(n(video)).all()
    np.testing.assert_allclose(n(video), want, atol=VIDEO_ATOL)
