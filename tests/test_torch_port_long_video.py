"""``pipelines/long_video.generate_long_video`` against the JAX package's, on
the CPU in fp32: the tiny mask+motion UNet under ``attn_impl="xla"``, the
tiny VAE, 2 DPM-Solver++ steps, two chunks of 3 frames with an overlap of 1
(5 frames: the second chunk re-noises the first one's last frame and is
conditioned on it).

JAX's draws (each chunk's start-latent noise, the second chunk's tail
noise) are recorded by wrapping ``jax.random.normal`` inside the test and
handed to the port as ``noise`` / ``tail_noise``; ``encode_prompt`` returns
shared random embeddings on both pipes. Tolerances as
``test_torch_port_pipeline.py``'s: 2e-5 of the largest latent, 2e-4 on the
video.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

VIDEO_ATOL, LATENT_REL = 2e-4, 2e-5
RES, CHUNK, OVERLAP, TOTAL, STEPS = 32, 3, 1, 5, 2


@pytest.fixture(scope="module")
def case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline
    from animate_anything_tpu.pipelines.long_video import generate_long_video

    r = np.random.default_rng(8)
    h8 = RES // 8
    req = dict(image=r.integers(0, 256, (RES, RES, 3), dtype=np.uint8),
               mask_img=np.where(r.random((RES, RES)) > 0.3, 255, 0).astype(np.uint8),
               embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
               neg=r.standard_normal((1, 77, 32)).astype(np.float32))
    cfg = dict(motion_mask=True, motion_strength=True, attn_impl="xla")
    z = np.zeros((1, 1, h8, h8, 4), np.float32)
    uparams = jax_params(JaxUNet(JaxCfg.tiny(**cfg)), z, np.int32(1), req["embeds"], z,
                         z[..., :1], np.ones(1, np.float32), seed=9)
    vae = JaxVAE(JaxVAECfg.tiny())
    vparams = jax_params(vae, jnp.zeros((1, RES, RES, 3)), seed=10)
    pipe = JaxPipeline(JaxUNet(JaxCfg.tiny(**cfg)), uparams, vae, vparams)
    pipe.encode_prompt = lambda prompt, negative_prompt="": (jnp.asarray(req["embeds"]),
                                                             jnp.asarray(req["neg"]))
    draws = []
    normal = jax.random.normal

    def recorded(key, shape, *a, **k):
        out = normal(key, shape, *a, **k)
        draws.append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", recorded)
        video, latents = generate_long_video(
            pipe, req["image"], "", total_frames=TOTAL, chunk_frames=CHUNK, overlap=OVERLAP,
            mask_img=req["mask_img"], motion_strength=5.0, num_inference_steps=STEPS,
            rng=jax.random.PRNGKey(12))
    return uparams, vparams, req, draws, np.asarray(video), np.asarray(latents)


def test_jax_draws_are_the_chunks_and_the_tail(case):
    draws = case[3]
    h8 = RES // 8
    assert [d.shape for d in draws] == [(1, CHUNK, h8, h8, 4), (1, CHUNK, h8, h8, 4),
                                        (1, OVERLAP, h8, h8, 4)]


@pytest.fixture(scope="module")
def port_result(case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.pipelines.long_video import generate_long_video
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    uparams, vparams, req, draws, _, _ = case
    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(
        motion_mask=True, motion_strength=True, attn_impl="xla")), unet3d_state_dict(uparams))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams))
    pipe = LatentToVideoPipeline(unet, vae)
    pipe.encode_prompt = lambda prompt, negative_prompt="": (t(req["embeds"]), t(req["neg"]))
    return generate_long_video(
        pipe, req["image"], "", total_frames=TOTAL, chunk_frames=CHUNK, overlap=OVERLAP,
        mask_img=req["mask_img"], motion_strength=5.0, num_inference_steps=STEPS,
        noise=[t(draws[0]), t(draws[1])], tail_noise=[t(draws[2])])


def test_long_video_latents_match_jax(case, port_result):
    want = case[5]
    _, latents = port_result
    assert latents.shape == want.shape == (1, TOTAL, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(n(latents), want, atol=LATENT_REL * np.abs(want).max())


def test_long_video_decoded_video_matches_jax(case, port_result):
    want = case[4]
    video, _ = port_result
    assert video.shape == want.shape == (1, TOTAL, RES, RES, 3)
    assert np.isfinite(n(video)).all()
    np.testing.assert_allclose(n(video), want, atol=VIDEO_ATOL)


def test_long_video_draws_from_the_generator_without_noise(case):
    """Without ``noise`` the draws come from the generator: the same seed
    gives the same latents, and ``decode=False`` returns none."""
    import torch

    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.pipelines.long_video import generate_long_video
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    uparams, vparams, req, _, _, _ = case
    pipe = LatentToVideoPipeline(
        load_into(UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True, motion_strength=True,
                                                         attn_impl="xla")),
                  unet3d_state_dict(uparams)),
        load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams)))
    pipe.encode_prompt = lambda prompt, negative_prompt="": (t(req["embeds"]), t(req["neg"]))
    runs = [generate_long_video(pipe, req["image"], "", total_frames=4, chunk_frames=CHUNK,
                                mask_img=req["mask_img"], num_inference_steps=STEPS,
                                decode=False,
                                generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert runs[0][0] is None and runs[0][1].shape == (1, 4, RES // 8, RES // 8, 4)
    assert torch.equal(runs[0][1], runs[1][1])
