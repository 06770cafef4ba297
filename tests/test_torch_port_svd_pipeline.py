"""The port's SVD pipelines (``pipelines/svd.py``) against the JAX package's
``animate_anything_tpu/pipelines/svd.py``, end to end on the CPU in fp32, 2
Euler steps over a 3-frame, 128×128 request with a two-level cut of the
tiny SVD UNet (``UNET_CUT``: these tests hold the pipeline's wiring; the
UNet itself is held at ``tiny()`` in ``test_torch_port_svd_unet.py``), the
tiny VAE and CLIP vision tower (and CLIP text for the text conditions).

This file: the 9-channel (motion mask) UNet under ``attn_impl="pallas"``
(the YAMLs' configuration; the JAX side as its tests run it on the CPU),
one ``TextStableVideoDiffusionPipeline`` on each side for two requests: an
image with a mask, and v2v (condition latents from a 3-frame video, through
both sides' ``video_to_condition_latent``) with a mask.
``test_torch_port_svd_pipeline8.py`` runs the 8-channel UNet under
``"xla"``: an image without a mask, ``condition_type="text"`` and
``condition_type="both"``.

JAX draws its start noise and the image's augmentation noise from
``jax.random.split(rng)``; the test draws the same two arrays from the same
key and hands them to the port as ``noise`` and ``aug_noise``.

Tolerances. The UNet agrees within 4e-6 on these inputs
(``test_torch_port_svd_unet.py``); the sampler does not add fp32 noise but
cancellation: the first Euler step from σ_max = 700 computes x + d·(σ' − σ)
on start latents of magnitude 700·max|noise| ≈ 2600 to reach latents of
magnitude ~5, so each side's result carries the rounding of that scale,
one fp32 ulp there (2.4e-4), in an order each compiler picks (XLA may fuse
the multiply-add). Measured: 1 such ulp between the two sides' latents,
2.2e-4 on the video (magnitude ~3). The latents are held to
``LATENT_ULPS`` ulps of the start latents' largest magnitude and the video
to ``VIDEO_ATOL``, four times the measured gaps; a wiring fault (the
channel order, the CFG halves, the guidance, the ids) moves them by ~0.1
or more.
"""

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

VIDEO_ATOL, LATENT_ULPS = 1e-3, 4
FRAMES, STEPS, RES = 3, 2, 128
# ``SVDUNetConfig.tiny`` cut to two levels of one resnet (and one
# transformer) each: a quarter of the layers for JAX to compile, every kind
# of block kept (the spatial resnet, kernel 3's resnet, kernel 1's flash at
# s = 256, kernel 5's block, the mid block at 8 × 8)
UNET_CUT = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4), layers_per_block=1)


def build_case(in_channels: int, attn_impl: str, text: bool):
    """Both sides' ``TextStableVideoDiffusionPipeline`` on the same tiny
    weights: → (jax pipeline, port pipeline)."""
    from animate_anything_tpu.models.clip_text import CLIPTextConfig as JaxTextCfg
    from animate_anything_tpu.models.clip_text import CLIPTextModel as JaxText
    from animate_anything_tpu.models.clip_vision import CLIPVisionConfig as JaxVisCfg
    from animate_anything_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxVis
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines.svd import TextStableVideoDiffusionPipeline as JaxPipe

    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                               CLIPVisionModelWithProjection)
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines.svd import TextStableVideoDiffusionPipeline
    from animate_anything_tpu_torch.utils.convert import (clip_text_state_dict,
                                                          clip_vision_state_dict,
                                                          svd_unet_state_dict, vae_state_dict)

    ucfg = JaxCfg.tiny(in_channels=in_channels, attn_impl=attn_impl, **UNET_CUT)
    z = np.zeros((1, 2, 8, 8, in_channels), np.float32)
    up = jax_params(JaxUNet(ucfg), z, np.float32(0.5), np.zeros((1, 1, 32), np.float32),
                    np.zeros((1, 3), np.float32))
    vp = jax_params(JaxVAE(JaxVAECfg.tiny()), np.zeros((1, 32, 32, 3), np.float32), seed=1)
    icfg = JaxVisCfg.tiny(projection_dim=32)
    ip = jax_params(JaxVis(icfg), np.zeros((1, 32, 32, 3), np.float32), seed=2)
    tp = tm = tok = None
    if text:
        tm = JaxText(JaxTextCfg.tiny(hidden_size=32))
        tp = jax_params(tm, np.zeros((1, 16), np.int32), seed=3)
        tok = HashTokenizer(64, 16)
    jpipe = JaxPipe(JaxUNet(ucfg), up, JaxVAE(JaxVAECfg.tiny()), vp, image_encoder=JaxVis(icfg),
                    image_encoder_params=ip, text_encoder=tm, text_params=tp, tokenizer=tok)

    unet = load_into(UNetSpatioTemporalConditionModel(
        SVDUNetConfig.tiny(in_channels=in_channels, attn_impl=attn_impl, **UNET_CUT)),
        svd_unet_state_dict(up))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vp))
    ienc = load_into(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny(projection_dim=32)),
                     clip_vision_state_dict(ip))
    text_model = (load_into(CLIPTextModel(CLIPTextConfig.tiny(hidden_size=32)),
                            clip_text_state_dict(tp)) if text else None)
    ppipe = TextStableVideoDiffusionPipeline(unet, vae, image_encoder=ienc,
                                             text_encoder=text_model, tokenizer=tok)
    return jpipe, ppipe


def run_both(jpipe, ppipe, seed: int, image=None, condition_latent=None, **kw):
    """One request on both sides with JAX's draws fed to the port → (jax
    video, jax latents, port video, port latents, the start latents'
    largest magnitude)."""
    rng = jax.random.PRNGKey(seed)
    r_aug, r_noise = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(r_noise, (1, FRAMES, RES // 8, RES // 8, 4)))
    aug = np.asarray(jax.random.normal(r_aug, (1, 1, RES, RES, 3)))
    common = dict(num_frames=FRAMES, num_inference_steps=STEPS, **kw)
    jcond = None if condition_latent is None else condition_latent[0]
    pcond = None if condition_latent is None else condition_latent[1]
    with pltpu.force_tpu_interpret_mode():
        jvid, jlat = jpipe(image, condition_latent=jcond, rng=rng,
                           mask=None if kw.get("mask") is None else np.asarray(kw["mask"]),
                           **{k: v for k, v in common.items() if k != "mask"})
    pvid, plat = ppipe(image, condition_latent=pcond, noise=t(noise), aug_noise=t(aug),
                       **{k: (t(v) if k == "mask" and v is not None else v)
                          for k, v in common.items()})
    start = np.float32(np.abs(noise).max() * np.sqrt(700.0 ** 2 + 1))
    return np.asarray(jvid), np.asarray(jlat), n(pvid), n(plat), start


def check(jvid, jlat, pvid, plat, start):
    """``start``: the start latents' largest magnitude."""
    assert pvid.shape == jvid.shape == (1, FRAMES, RES, RES, 3)
    assert plat.shape == jlat.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    assert np.isfinite(plat).all() and np.isfinite(pvid).all()
    np.testing.assert_allclose(plat, jlat, atol=LATENT_ULPS * float(np.spacing(start)))
    np.testing.assert_allclose(pvid, jvid, atol=VIDEO_ATOL)


def request_inputs(seed: int = 0):
    r = np.random.default_rng(seed)
    image = r.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    mask = (r.random((1, 1, RES // 8, RES // 8, 1)) > 0.5).astype(np.float32)
    video = r.integers(0, 256, (FRAMES, RES, RES, 3), dtype=np.uint8)
    return image, mask, video


@pytest.fixture(scope="module")
def pipes():
    return build_case(9, "pallas", text=False)


def test_image_with_mask_matches_jax(pipes):
    image, mask, _ = request_inputs()
    check(*run_both(*pipes, 0, image=image, mask=mask, fps=7, motion_bucket_id=127))


def test_v2v_condition_latent_matches_jax(pipes):
    jpipe, ppipe = pipes
    _, mask, video = request_inputs(1)
    jcond = jpipe.video_to_condition_latent(video)
    pcond = ppipe.video_to_condition_latent(video)
    assert tuple(pcond.shape) == jcond.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(n(pcond), np.asarray(jcond), atol=1e-5)
    image = np.zeros((RES, RES, 3), np.uint8)     # the image embedding's source only
    check(*run_both(jpipe, ppipe, 1, image=image, condition_latent=(jcond, pcond), mask=mask,
                    min_guidance_scale=2.0, max_guidance_scale=2.0))
