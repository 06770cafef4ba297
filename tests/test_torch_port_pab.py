"""PAB step caching (``models/pab.py``) in the port's two pipelines against
the JAX package's, end to end on the CPU in fp32, 6 steps with ``warmup`` 1
and ``tail`` 1, so that both the compute and the reuse branch run and the
spatial and temporal flags part:

- ``LatentToVideoPipeline(pab=...)`` on the tiny mask+motion UNet under
  ``attn_impl="pallas"`` (flash in interpret mode, the temporal blocks on
  the composite path on both sides, as ``test_torch_port_pipeline.py``
  runs it), spatial rate 2 and temporal rate 3: the spatial transformers
  reuse at steps 1 and 3, the temporal ones at 1, 2 and 4;
- ``TextStableVideoDiffusionPipeline(pab=...)`` on the two-level tiny SVD
  UNet (``test_torch_port_svd_pipeline.UNET_CUT``) at 9 channels under
  ``"pallas"``, rate 2: every transformer reuses at steps 1 and 3;
- the schedule's flags against JAX's, and the port's transformers' bodies
  run only on their compute steps (no kernel of a reuse step launches).

Tolerances as in the exact pipelines' tests (the same arithmetic: a reuse
step adds a delta both sides computed at an earlier step):
``test_torch_port_pipeline.py``'s 2e-5 of the largest latent and 2e-4 on
the video; ``test_torch_port_svd_pipeline.py``'s fp32 ulps of the start
latents and 1e-3 on the video.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import composite_temporal, jax_params, load_into, n, t
from test_torch_port_helpers import one_thread  # noqa: F401

STEPS = 6
PAB = {"spatial_rate": 2, "temporal_rate": 3, "warmup": 1, "tail": 1}
SVD_PAB = {"rate": 2, "warmup": 1, "tail": 1}
FRAMES, RES = 3, 64
VIDEO_ATOL, LATENT_REL = 2e-4, 2e-5
SVD_VIDEO_ATOL, SVD_LATENT_ULPS = 1e-3, 4


@pytest.mark.parametrize("steps", [6, 25])
def test_flags_match_jax_schedule(steps):
    """The port's flags against the expressions of JAX's denoise functions
    (``latent2video.py`` and ``svd.py``) at the default and the test configs;
    at 25 steps with the defaults the spatial transformers compute on 15
    steps and the temporal ones on 11."""
    from animate_anything_tpu_torch.models.pab import svd_flags, unet3d_flags

    idx = np.arange(steps)
    for cfg in (PAB, {}):
        sr, tr = cfg.get("spatial_rate", 2), cfg.get("temporal_rate", 3)
        mid = (idx >= cfg.get("warmup", 4)) & (idx < steps - cfg.get("tail", 1))
        sflags, tflags = unet3d_flags(cfg, steps)
        np.testing.assert_array_equal(sflags, mid & (idx % sr != 0))
        np.testing.assert_array_equal(tflags, mid & (idx % tr != 0))
        svd_cfg = {k: cfg[k] for k in ("warmup", "tail") if k in cfg}
        np.testing.assert_array_equal(svd_flags(svd_cfg, steps), mid & (idx % 2 != 0))
    sflags, tflags = unet3d_flags({}, 25)
    assert (~sflags).sum() == 15 and (~tflags).sum() == 11
    assert not unet3d_flags({"spatial_rate": 1, "temporal_rate": 0}, steps)[0].any()


@pytest.fixture(scope="module")
def unet3d_case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg
    from animate_anything_tpu.pipelines import LatentToVideoPipeline as JaxPipeline

    r = np.random.default_rng(3)
    h8 = RES // 8
    req = dict(
        image=r.integers(0, 256, (RES, RES, 3), dtype=np.uint8),
        mask_img=np.where(r.random((RES, RES)) > 0.5, 255, 0).astype(np.uint8),
        motion_strength=4.0,
        prompt_embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
        negative_prompt_embeds=r.standard_normal((1, 77, 32)).astype(np.float32),
    )
    jax_cfg = dict(motion_mask=True, motion_strength=True)
    z = np.zeros((1, 1, h8, h8, 4), np.float32)
    uparams = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **jax_cfg)), z, np.int32(1),
                         req["prompt_embeds"], z, z[..., :1], np.ones(1, np.float32), seed=5)
    vae = JaxVAE(JaxVAECfg.tiny())
    vparams = jax_params(vae, jnp.zeros((1, RES, RES, 3)), seed=6)
    pipe = JaxPipeline(JaxUNet(JaxCfg.tiny(attn_impl="pallas", **jax_cfg)), uparams, vae,
                       vparams, pab=PAB)
    pipe.encode_prompt = lambda prompt, negative_prompt="": (
        jnp.asarray(req["prompt_embeds"]), jnp.asarray(req["negative_prompt_embeds"]))
    key = jax.random.PRNGKey(7)
    with composite_temporal(), pltpu.force_tpu_interpret_mode():
        video, latents = pipe.animate_image(
            req["image"], "", mask_img=req["mask_img"], motion_strength=req["motion_strength"],
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0, rng=key)
    noise = jax.random.normal(key, (1, FRAMES, h8, h8, 4), jnp.float32)
    return uparams, vparams, req, np.asarray(noise), np.asarray(video), np.asarray(latents)


def _count_bodies(monkeypatch, classes) -> dict:
    """Count each class's ``_delta`` calls (the transformer's body)."""
    seen = {cls.__name__: 0 for cls in classes}
    for cls in classes:
        orig = cls._delta

        def counted(self, *a, _orig=orig, _name=cls.__name__, **k):
            seen[_name] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, "_delta", counted)
    return seen


@pytest.fixture(scope="module")
def unet3d_port(unet3d_case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.attention import (SpatialTransformer,
                                                             TemporalTransformer)
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    uparams, vparams, req, noise, _, _ = unet3d_case
    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True,
                                                            motion_strength=True,
                                                            attn_impl="pallas")),
                     unet3d_state_dict(uparams))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams))
    pipe = LatentToVideoPipeline(unet, vae, pab=PAB)
    pipe.encode_prompt = lambda prompt, negative_prompt="": (
        t(req["prompt_embeds"]), t(req["negative_prompt_embeds"]))
    modules = {cls: sum(isinstance(m, cls) for m in unet.modules())
               for cls in (SpatialTransformer, TemporalTransformer)}
    with composite_temporal(), pytest.MonkeyPatch.context() as mp:
        seen = _count_bodies(mp, modules)
        video, latents = pipe.animate_image(
            req["image"], "", mask_img=req["mask_img"], motion_strength=req["motion_strength"],
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0, noise=t(noise))
    return video, latents, seen, {cls.__name__: k for cls, k in modules.items()}


def test_unet3d_pab_latents_match_jax(unet3d_case, unet3d_port):
    want = unet3d_case[5]
    _, latents, _, _ = unet3d_port
    assert latents.shape == want.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(n(latents), want, atol=LATENT_REL * np.abs(want).max())


def test_unet3d_pab_video_matches_jax(unet3d_case, unet3d_port):
    want = unet3d_case[4]
    video, _, _, _ = unet3d_port
    assert np.isfinite(n(video)).all()
    np.testing.assert_allclose(n(video), want, atol=VIDEO_ATOL)


def test_unet3d_pab_reuse_steps_run_no_transformer_body(unet3d_port):
    """Spatial transformers compute on 4 of the 6 steps, temporal ones
    (``transformer_in`` included) on 3; the others add their cached delta."""
    _, _, seen, modules = unet3d_port
    assert modules["SpatialTransformer"] > 0 and modules["TemporalTransformer"] > 0
    assert seen == {"SpatialTransformer": 4 * modules["SpatialTransformer"],
                    "TemporalTransformer": 3 * modules["TemporalTransformer"]}


def test_pab_differs_from_the_exact_request(unet3d_case, unet3d_port):
    """The cache changes the result (a reused delta is not the recomputed
    one), so the parity above holds PAB, not the exact path."""
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict, vae_state_dict

    uparams, vparams, req, noise, _, want = unet3d_case
    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True,
                                                            motion_strength=True,
                                                            attn_impl="pallas")),
                     unet3d_state_dict(uparams))
    pipe = LatentToVideoPipeline(unet, load_into(AutoencoderKL(VAEConfig.tiny()),
                                                 vae_state_dict(vparams)))
    pipe.encode_prompt = lambda prompt, negative_prompt="": (
        t(req["prompt_embeds"]), t(req["negative_prompt_embeds"]))
    with composite_temporal():
        _, exact = pipe.animate_image(
            req["image"], "", mask_img=req["mask_img"], motion_strength=req["motion_strength"],
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0, noise=t(noise))
    gap = np.abs(n(exact) - want).max()
    assert gap > 100 * LATENT_REL * np.abs(want).max()


@pytest.fixture(scope="module")
def svd_result():
    from test_torch_port_svd_pipeline import build_case

    from animate_anything_tpu_torch.models.svd_unet import TransformerSpatioTemporalModel

    jpipe, ppipe = build_case(9, "pallas", text=False)
    jpipe.pab, ppipe.pab = dict(SVD_PAB), dict(SVD_PAB)
    r = np.random.default_rng(4)
    image = r.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    mask = (r.random((1, 1, RES // 8, RES // 8, 1)) > 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    r_aug, r_noise = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(r_noise, (1, FRAMES, RES // 8, RES // 8, 4)))
    aug = np.asarray(jax.random.normal(r_aug, (1, 1, RES, RES, 3)))
    common = dict(num_frames=FRAMES, num_inference_steps=STEPS, fps=7, motion_bucket_id=127)
    with pltpu.force_tpu_interpret_mode():
        jvid, jlat = jpipe(image, mask=mask, rng=rng, **common)
    count = sum(isinstance(m, TransformerSpatioTemporalModel) for m in ppipe.unet.modules())
    with pytest.MonkeyPatch.context() as mp:
        seen = _count_bodies(mp, [TransformerSpatioTemporalModel])
        pvid, plat = ppipe(image, mask=t(mask), noise=t(noise), aug_noise=t(aug), **common)
    start = np.float32(np.abs(noise).max() * np.sqrt(700.0 ** 2 + 1))
    return np.asarray(jvid), np.asarray(jlat), n(pvid), n(plat), start, seen, count


def test_svd_pab_matches_jax(svd_result):
    jvid, jlat, pvid, plat, start, _, _ = svd_result
    assert plat.shape == jlat.shape == (1, FRAMES, RES // 8, RES // 8, 4)
    assert np.isfinite(pvid).all()
    np.testing.assert_allclose(plat, jlat, atol=SVD_LATENT_ULPS * float(np.spacing(start)))
    np.testing.assert_allclose(pvid, jvid, atol=SVD_VIDEO_ATOL)


def test_svd_pab_reuse_steps_run_no_transformer_body(svd_result):
    *_, seen, count = svd_result
    assert count > 0
    assert seen == {"TransformerSpatioTemporalModel": 4 * count}
