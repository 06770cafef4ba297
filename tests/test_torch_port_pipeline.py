"""The port's image-to-video pipeline against the JAX package's, end to end
on the CPU in fp32: ``LatentToVideoPipeline.animate_image`` with the tiny
mask+motion UNet (``attn_impl="pallas"``, flash in interpret mode, the
temporal blocks on the composite path on both sides through ``fused_ok``),
the tiny VAE, 2 DPM-Solver++ steps under CFG 9. The fused temporal path,
with the prompt encoded by the CLIP text encoder, is held in
``test_torch_port_clip.py``.

Both pipelines take a prompt string; here ``encode_prompt`` is replaced on
both sides by one that returns shared random embeddings. The noise JAX
draws for the start latents is drawn again from the same key and handed to
the port. Tolerances: CFG 9 multiplies the difference of two UNet outputs
by 9, on top of fp32 noise through UNet, sampler and VAE. With random
weights the latents reach magnitude ~90, so theirs is relative to the
largest value, 2e-5·max|want| (5e-6 measured); the decoded video (magnitude
~3) is held at 2e-4 absolute (1.5e-5 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import composite_temporal, jax_params, load_into, n, t

VIDEO_ATOL, LATENT_REL = 2e-4, 2e-5
FRAMES, STEPS, RES = 3, 2, 128


@pytest.fixture(scope="module")
def case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline

    r = np.random.default_rng(0)
    h8 = RES // 8
    req = dict(
        image=r.integers(0, 256, (RES, RES, 3), dtype=np.uint8),
        mask_img=np.where(r.random((RES, RES)) > 0.5, 255, 0).astype(np.uint8),
        motion_strength=6.0,
        prompt_embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
        negative_prompt_embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
    )
    jax_cfg = dict(motion_mask=True, motion_strength=True)
    z = np.zeros((1, 1, h8, h8, 4), np.float32)
    uparams = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **jax_cfg)), z, np.int32(1),
                         req["prompt_embeds"], z, z[..., :1], np.ones(1, np.float32))
    vae = JaxVAE(JaxVAECfg.tiny())
    vparams = jax_params(vae, jnp.zeros((1, RES, RES, 3)), seed=1)
    pipe = JaxPipeline(JaxUNet(JaxCfg.tiny(attn_impl="pallas", **jax_cfg)), uparams, vae,
                       vparams)
    pipe.encode_prompt = lambda prompt, negative_prompt="": (
        jnp.asarray(req["prompt_embeds"]), jnp.asarray(req["negative_prompt_embeds"]))
    key = jax.random.PRNGKey(11)
    with composite_temporal(), pltpu.force_tpu_interpret_mode():
        video, latents = pipe.animate_image(
            req["image"], "", mask_img=req["mask_img"], motion_strength=req["motion_strength"],
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0, rng=key)
    noise = jax.random.normal(key, (1, FRAMES, h8, h8, 4), jnp.float32)
    return uparams, vparams, req, np.asarray(noise), np.asarray(video), np.asarray(latents)


@pytest.fixture(scope="module")
def port_result(case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    uparams, vparams, req, noise, _, _ = case
    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True,
                                                            motion_strength=True,
                                                            attn_impl="pallas")),
                     unet3d_state_dict(uparams))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams))
    pipe = LatentToVideoPipeline(unet, vae)
    pipe.encode_prompt = lambda prompt, negative_prompt="": (
        t(req["prompt_embeds"]), t(req["negative_prompt_embeds"]))
    with composite_temporal():
        return pipe.animate_image(
            req["image"], "", mask_img=req["mask_img"], motion_strength=req["motion_strength"],
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0, noise=t(noise))


def test_two_step_pipeline_latents_match_jax(case, port_result):
    want = case[5]
    _, latents = port_result
    assert latents.shape == want.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(n(latents), want, atol=LATENT_REL * np.abs(want).max())


def test_two_step_pipeline_video_matches_jax(case, port_result):
    want = case[4]
    video, _ = port_result
    assert video.shape == want.shape == (1, FRAMES, RES, RES, 3)
    assert np.isfinite(n(video)).all()
    np.testing.assert_allclose(n(video), want, atol=VIDEO_ATOL)


@pytest.mark.parametrize("steps,fraction", [(25, 0.0), (25, 0.3), (10, 0.5)])
def test_truncated_timesteps_match_jax(steps, fraction):
    """``t_start_fraction`` drops the noisiest share of the DPM-Solver++ grid,
    as JAX's ``get_timesteps`` does."""
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    want = JaxPipeline(None, None, None, None).get_timesteps(steps, fraction)
    got = LatentToVideoPipeline(None, None).get_timesteps(steps, fraction)
    assert len(got) == steps - int(steps * fraction)
    np.testing.assert_array_equal(got, want)
