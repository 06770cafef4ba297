"""The port's DDIM sampler against the JAX package's, on the CPU in fp32:

- ``ddim_timesteps`` for the three spacings at several step counts (exact);
- ``ddim_step`` under ε and v prediction, including the final step
  (``t_prev < 0``; atol 1e-6 on values of magnitude ~3: fp32 rounding of
  the same formula);
- the loop's step to ``t − T // len(grid)``, which JAX takes also on a
  truncated grid whose own spacing is wider (pinned, as recorded in
  ROADMAP queue 3);
- a 2-step tiny image-to-video pipeline under ``sampler="ddim"``, on the
  full grid and on a truncated one (``attn_impl="xla"`` on both sides), the
  noise JAX draws handed to the port; tolerances as
  ``test_torch_port_pipeline.py`` (latents 2e-5 of their largest value,
  video 2e-4 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_params, load_into, n, t

VIDEO_ATOL, LATENT_REL, STEP_ATOL = 2e-4, 2e-5, 1e-6
FRAMES, RES = 3, 64


@pytest.mark.parametrize("spacing", ["leading", "linspace", "trailing"])
@pytest.mark.parametrize("steps", [1, 2, 4, 25, 50, 999])
def test_ddim_timesteps_match_jax(spacing, steps):
    from animate_anything_tpu.diffusion.samplers import ddim_timesteps as jax_ts
    from animate_anything_tpu_torch.diffusion import ddim_timesteps

    got, want = ddim_timesteps(1000, steps, spacing), jax_ts(1000, steps, spacing)
    assert got.dtype == np.int64 and len(got) == steps
    np.testing.assert_array_equal(got, want)


def test_ddim_timesteps_refuse_an_unknown_spacing():
    from animate_anything_tpu_torch.diffusion import ddim_timesteps

    with pytest.raises(ValueError):
        ddim_timesteps(1000, 4, "uniform")


def _schedules(prediction_type):
    from animate_anything_tpu.diffusion import make_schedule as jax_make
    from animate_anything_tpu_torch.diffusion import make_schedule

    return (make_schedule(prediction_type=prediction_type),
            jax_make(prediction_type=prediction_type))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("t_now,t_prev", [(951, 901), (501, 251), (251, 1), (1, -249),
                                         (40, -10)])
def test_ddim_step_matches_jax(prediction_type, t_now, t_prev):
    from animate_anything_tpu.diffusion.samplers import ddim_step as jax_step
    from animate_anything_tpu_torch.diffusion import ddim_step

    sched, jax_sched = _schedules(prediction_type)
    r = np.random.default_rng(t_now)
    sample, out = (r.standard_normal((1, 2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    want = jax_step(jax_sched, jnp.asarray(sample), jnp.asarray(out), jnp.asarray(t_now),
                    jnp.asarray(t_prev))
    got = ddim_step(sched, t(sample), t(out), t_now, t_prev)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=STEP_ATOL)


def test_ddim_step_keeps_the_sample_dtype():
    from animate_anything_tpu_torch.diffusion import ddim_step

    sched, _ = _schedules("epsilon")
    x = torch.randn(1, 2, 4, 4, 4).bfloat16()
    assert ddim_step(sched, x, torch.randn(1, 2, 4, 4, 4), 501, 251).dtype == torch.bfloat16


@pytest.mark.parametrize("steps,fraction", [(4, 0.0), (4, 0.5), (10, 0.3)])
def test_ddim_loop_steps_by_t_over_the_grid_length_as_jax(steps, fraction):
    """On a truncated grid JAX's loop steps from each t to t − T // len(grid),
    not to the grid's next t: 4 steps from 0.5 keep [251, 1] and step by 500,
    where the grid's own gap is 250. The port follows it."""
    from animate_anything_tpu.diffusion.samplers import sample_loop as jax_loop
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline
    from animate_anything_tpu_torch.diffusion import ddim_step, sample_loop
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    sched, jax_sched = _schedules("epsilon")
    ts = LatentToVideoPipeline(None, None, sampler="ddim").get_timesteps(steps, fraction)
    np.testing.assert_array_equal(
        ts, JaxPipeline(None, None, None, None, sampler="ddim").get_timesteps(steps, fraction))
    r = np.random.default_rng(steps)
    x = r.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)

    def model_fn(sample, step):
        return 0.5 * sample + 1e-3 * step

    seen = []
    got = sample_loop(sched, t(x), ts, lambda s, step: seen.append(step) or model_fn(s, step),
                      sampler="ddim")
    want = jax_loop(jax_sched, jnp.asarray(x), ts, model_fn, sampler="ddim")
    assert seen == [int(v) for v in ts]
    np.testing.assert_allclose(n(got), np.asarray(want), atol=STEP_ATOL)
    gap = 1000 // len(ts)
    manual = t(x)
    for step in ts:
        manual = ddim_step(sched, manual, model_fn(manual, int(step)), int(step), int(step) - gap)
    np.testing.assert_allclose(n(got), n(manual), atol=STEP_ATOL)
    if fraction:   # the truncated grid's own spacing is not the step taken
        assert len(ts) > 1 and ts[0] - ts[1] != gap


@pytest.fixture(scope="module")
def weights():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg

    r = np.random.default_rng(0)
    h8 = RES // 8
    req = dict(
        image=r.integers(0, 256, (RES, RES, 3), dtype=np.uint8),
        mask_img=np.where(r.random((RES, RES)) > 0.5, 255, 0).astype(np.uint8),
        motion_strength=6.0,
        prompt_embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
        negative_prompt_embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
    )
    z = np.zeros((1, 1, h8, h8, 4), np.float32)
    uparams = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", motion_mask=True,
                                             motion_strength=True)),
                         z, np.int32(1), req["prompt_embeds"], z, z[..., :1],
                         np.ones(1, np.float32))
    vparams = jax_params(JaxVAE(JaxVAECfg.tiny()), jnp.zeros((1, RES, RES, 3)), seed=1)
    return uparams, vparams, req


@pytest.mark.parametrize("steps,fraction", [(2, 0.0), (4, 0.5)], ids=["full", "truncated"])
def test_ddim_pipeline_matches_jax(weights, steps, fraction):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    uparams, vparams, req = weights
    cfg = dict(motion_mask=True, motion_strength=True, attn_impl="xla")
    jpipe = JaxPipeline(JaxUNet(JaxCfg.tiny(**cfg)), uparams, JaxVAE(JaxVAECfg.tiny()), vparams,
                        sampler="ddim")
    jpipe.encode_prompt = lambda prompt, negative_prompt="": (
        jnp.asarray(req["prompt_embeds"]), jnp.asarray(req["negative_prompt_embeds"]))
    key = jax.random.PRNGKey(5)
    kw = dict(mask_img=req["mask_img"], motion_strength=req["motion_strength"],
              num_frames=FRAMES, num_inference_steps=steps, guidance_scale=9.0,
              t_start_fraction=fraction)
    want_video, want_latents = jpipe.animate_image(req["image"], "", rng=key, **kw)
    noise = jax.random.normal(key, (1, FRAMES, RES // 8, RES // 8, 4), jnp.float32)

    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(**cfg)), unet3d_state_dict(uparams))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams))
    pipe = LatentToVideoPipeline(unet, vae, sampler="ddim")
    pipe.encode_prompt = lambda prompt, negative_prompt="": (
        t(req["prompt_embeds"]), t(req["negative_prompt_embeds"]))
    video, latents = pipe.animate_image(req["image"], "", noise=t(np.asarray(noise)), **kw)
    want_latents = np.asarray(want_latents)
    assert latents.shape == want_latents.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(n(latents), want_latents,
                               atol=LATENT_REL * np.abs(want_latents).max())
    assert np.isfinite(n(video)).all()
    np.testing.assert_allclose(n(video), np.asarray(want_video), atol=VIDEO_ATOL)


def test_pipeline_refuses_an_unknown_sampler():
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    with pytest.raises(ValueError, match="sampler"):
        LatentToVideoPipeline(None, None, sampler="euler")
