"""The slice as a whole in the JAX package's opt-in GroupNorm and resnet-conv
configuration: ``set_default_norm_impl("pallas")``,
``set_default_stats_impl("pallas")`` and ``AA_SPATIAL_CONV=1`` on both
sides, on the CPU, in fp32.

1. the tiny mask+motion UNet forward against JAX's ``attn_impl="pallas"``
   model (Pallas kernels in interpret mode), atol 5e-5 as in
   ``test_torch_port_unet.py``;
2. a small VAE whose widths are 128s, so that its GroupNorms pass the
   one-pass kernel's gate (the tiny models' widths never do), decoded on
   both sides, atol 2e-4 as the pipeline's video;
3. a 2-step image-to-video request through both pipelines, held as
   ``test_torch_port_pipeline.py`` holds the default one.

Each part counts, on both sides, the calls that only the opt-in
configuration makes: JAX's ``_pallas_channel_sums``, ``_pallas_group_norm``
and the fused resnet stage (its XLA twin ``_reference_stage`` off the TPU);
the port's ``stream_channel_sums``, ``group_norm_stream`` and
``spatial_conv``. A part whose counts stayed at zero would compare the
default configuration with itself.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, t

UNET_ATOL, VIDEO_ATOL, LATENT_REL = 5e-5, 2e-4, 2e-5


@contextlib.contextmanager
def opt_in_both(monkeypatch):
    """Both packages in the opt-in configuration, JAX's kernels in interpret
    mode; yields the call counters {name: mock}. Everything is restored on
    exit (an xdist worker keeps module state across a file's tests)."""
    from animate_anything_tpu.ops import group_norm as jgn
    from animate_anything_tpu.ops.attic import spatial_conv as jsc
    from animate_anything_tpu.ops.attic import streaming_group_norm as jsg
    from animate_anything_tpu_torch.ops import group_norm as gn
    from animate_anything_tpu_torch.ops import spatial_conv as sc
    from animate_anything_tpu_torch.ops import streaming_group_norm as sg

    monkeypatch.setenv("AA_SPATIAL_CONV", "1")
    targets = {"jax_channel_sums": (jgn, "_pallas_channel_sums"),
               "jax_group_norm": (jsg, "_pallas_group_norm"),
               "jax_spatial_conv": (jsc, "_reference_stage"),
               "channel_sums": (gn, "stream_channel_sums"),
               "group_norm": (sg, "group_norm_stream"),
               "spatial_conv": (sc, "spatial_conv")}
    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(mock.patch.object(mod, name, wraps=getattr(mod, name)))
                 for k, (mod, name) in targets.items()}
        stack.enter_context(pltpu.force_tpu_interpret_mode())
        try:
            for mod in (jgn, gn):
                mod.set_default_norm_impl("pallas")
                mod.set_default_stats_impl("pallas")
            yield calls
        finally:
            for mod in (jgn, gn):
                mod.set_default_norm_impl("xla")
                mod.set_default_stats_impl("xla")


def _counts(calls):
    return {k: m.call_count for k, m in calls.items()}


def test_tiny_unet_forward_opt_in_matches_jax(monkeypatch):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    r = np.random.default_rng(0)
    b, f, hw = 2, 3, 16
    args = (r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), np.int32(721),
            r.standard_normal((b, 77, 32)).astype(np.float32),
            r.standard_normal((b, 1, hw, hw, 4)).astype(np.float32),
            (r.random((b, 1, hw, hw, 1)) > 0.5).astype(np.float32),
            np.array([2.0, 8.0], np.float32))
    cfg = dict(motion_mask=True, motion_strength=True)
    params = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **cfg)), *args)
    model = JaxUNet(JaxCfg.tiny(attn_impl="pallas", **cfg))
    port = load_into(UNet3DConditionModel(UNet3DConfig.tiny(attn_impl="pallas", **cfg)),
                     unet3d_state_dict(params))
    with opt_in_both(monkeypatch) as calls:
        # a fresh function, so no trace cached under the default switches is reused
        want = np.asarray(jax.jit(lambda *a: model.apply(*a))(params, *args))
        with torch.no_grad():
            got = port(t(args[0]), int(args[1]), t(args[2]), t(args[3]), t(args[4]),
                       t(args[5]))
        counts = _counts(calls)
    # 22 resnets x 2 stages on each side; the tiny widths (32, 64) never pass
    # the one-pass GroupNorm's c % 128 gate, on either side
    assert counts["jax_spatial_conv"] == counts["spatial_conv"] == 44, counts
    assert counts["jax_channel_sums"] > 0 and counts["channel_sums"] > 0, counts
    assert counts["jax_group_norm"] == counts["group_norm"] == 0, counts
    assert got.shape == want.shape == args[0].shape
    np.testing.assert_allclose(n(got), want, atol=UNET_ATOL)


def test_wide_vae_decode_opt_in_matches_jax(monkeypatch):
    """Every GroupNorm of a VAE decoder with 128-wide levels takes the
    one-pass kernel on both sides."""
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxCfg
    from animate_anything_tpu.models.vae import decode_video as jax_decode
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig, decode_video
    from animate_anything_tpu_torch.utils.convert import vae_state_dict

    kw = dict(block_out_channels=(128,) * 4, layers_per_block=1, norm_num_groups=32)
    z = np.random.default_rng(1).standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    jv = JaxVAE(JaxCfg(**kw))
    p = jax_params(jv, jnp.zeros((1, 32, 32, 3)))
    port = load_into(AutoencoderKL(VAEConfig(**kw)), vae_state_dict(p))
    with opt_in_both(monkeypatch) as calls:
        want = np.asarray(jax_decode(jv, p, jnp.asarray(z)))
        with torch.no_grad():
            got = decode_video(port, t(z))
        counts = _counts(calls)
    # mid block: 2 resnets x 2 + attention 1; up blocks: 4 x 2 resnets x 2; norm out 1
    assert counts["jax_group_norm"] == counts["group_norm"] == 22, counts
    assert got.shape == want.shape == (1, 2, 32, 32, 3)
    np.testing.assert_allclose(n(got), want, atol=VIDEO_ATOL)


@pytest.mark.slow
def test_two_step_pipeline_opt_in_matches_jax(monkeypatch):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    frames, steps, res = 3, 2, 128
    r = np.random.default_rng(2)
    image = r.integers(0, 256, (res, res, 3), dtype=np.uint8)
    mask = np.where(r.random((res, res)) > 0.5, 255, 0).astype(np.uint8)
    pe, ne = (r.standard_normal((1, 77, 32)).astype(np.float32) for _ in range(2))
    cfg = dict(motion_mask=True, motion_strength=True)
    zl = np.zeros((1, 1, res // 8, res // 8, 4), np.float32)
    uparams = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **cfg)), zl, np.int32(1), pe,
                         zl, zl[..., :1], np.ones(1, np.float32))
    vae = JaxVAE(JaxVAECfg.tiny())
    vparams = jax_params(vae, jnp.zeros((1, res, res, 3)), seed=1)
    jpipe = JaxPipeline(JaxUNet(JaxCfg.tiny(attn_impl="pallas", **cfg)), uparams, vae, vparams)
    jpipe.encode_prompt = lambda prompt, negative_prompt="": (jnp.asarray(pe), jnp.asarray(ne))
    pipe = LatentToVideoPipeline(
        load_into(UNet3DConditionModel(UNet3DConfig.tiny(attn_impl="pallas", **cfg)),
                  unet3d_state_dict(uparams)),
        load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams)))
    pipe.encode_prompt = lambda prompt, negative_prompt="": (t(pe), t(ne))
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (1, frames, res // 8, res // 8, 4), jnp.float32))
    req = dict(mask_img=mask, motion_strength=6.0, num_frames=frames,
               num_inference_steps=steps, guidance_scale=9.0)
    with opt_in_both(monkeypatch) as calls:
        want_video, want_latents = jpipe.animate_image(image, "", rng=key, **req)
        video, latents = pipe.animate_image(image, "", noise=t(noise), **req)
        counts = _counts(calls)
    assert counts["jax_spatial_conv"] > 0 and counts["spatial_conv"] == 2 * 44, counts
    assert counts["jax_channel_sums"] > 0 and counts["channel_sums"] > 0, counts
    want_latents = np.asarray(want_latents)
    np.testing.assert_allclose(n(latents), want_latents,
                               atol=LATENT_REL * np.abs(want_latents).max())
    np.testing.assert_allclose(n(video), np.asarray(want_video), atol=VIDEO_ATOL)
