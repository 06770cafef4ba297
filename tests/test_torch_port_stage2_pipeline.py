"""The port's stage-2 pipelines (``pipelines/stage2.py``) against the JAX
package's, end to end on the CPU in fp32, and the stage-2 entry point
(``cli_stage2``).

Both pipelines take 2 DPM-Solver++ steps over a 3-frame 64×64 RGBA request
(the prompt through each side's hash tokenizer and tiny CLIP text encoder,
CFG 9, motion strength 5) with a two-level cut of the tiny UNet, the tiny
VAE and the tiny ``UNet384``: the Masked pipeline (5 channels, frame concat)
under ``attn_impl="pallas"`` (JAX's Pallas flash in interpret mode), the
Concat pipeline (9 channels, ``condition_mode="channel_concat"``) under
``"xla"``. The RGBA latent is JAX's ``build_rgba_latents`` (held on its own
in ``test_torch_port_stage2.py``) and the start latents JAX's
``prepare_init_latents`` draw; both go to the port as they are.

Tolerances: the latents, the video and the colour of the RGBA output each
within 2e-5 of the array's largest magnitude (fp32 noise through two UNet
steps under CFG 9, which scales a difference of the two halves by 9, and a
decode; the latents reach ~40 with these random weights, and 6e-6 of that
was measured); the binarised alpha equal wherever JAX's pre-threshold value
is not within 1e-3 of the threshold.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

SCALE_TOL = 2e-5
FRAMES, STEPS, RES = 3, 2, 64
UNET_CUT = dict(block_out_channels=(32, 64), layers_per_block=1,
                down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
                up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"))
UNET384_TINY = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=4, norm_num_groups=2)
PROMPT = "a cup turns"


@pytest.fixture(scope="module")
def shared():
    """The VAE, text encoder, UNet384 and offset encoder params (JAX trees)."""
    from animate_anything_tpu.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu.models.transparent_vae import (LatentTransparencyOffsetEncoder,
                                                             UNet384, UNet384Config)
    from animate_anything_tpu.models.vae import AutoencoderKL, VAEConfig

    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextModel(CLIPTextConfig.tiny())
    dec, enc = UNet384(UNet384Config(**UNET384_TINY)), LatentTransparencyOffsetEncoder()
    z = np.zeros((1, RES, RES, 3), np.float32)
    return dict(vae=vae, vae_params=jax_params(vae, z, seed=1), text=text,
                text_params=jax_params(text, np.zeros((1, 16), np.int32), seed=2),
                dec=dec, dec_params=jax_params(dec, z, np.zeros((1, 8, 8, 4), np.float32),
                                               seed=3),
                enc=enc, enc_params=jax_params(enc, np.zeros((1, RES, RES, 4), np.float32),
                                               seed=4))


def _run(shared, concat: bool, impl: str):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.factory import HashTokenizer as JaxTok
    from animate_anything_tpu.models.transparent_vae import build_rgba_latents
    from animate_anything_tpu.pipelines import stage2 as jax_stage2

    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.models.transparent_vae import UNet384, UNet384Config
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import stage2
    from animate_anything_tpu_torch.utils.convert import (clip_text_state_dict,
                                                          unet3d_state_dict, unet384_state_dict,
                                                          vae_state_dict)

    kw = dict(motion_mask=True, motion_strength=True, **UNET_CUT)
    if concat:
        kw["condition_mode"] = "channel_concat"
    r = np.random.default_rng(5)
    z = np.zeros((1, 2, 8, 8, 4), np.float32)
    up = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **kw)), z, np.int32(1),
                    np.zeros((1, 16, 32), np.float32), z[:, :1], z[:, :1, ..., :1],
                    np.ones(1, np.float32), seed=6)
    name = "ConcatLatentToVideoPipeline" if concat else "MaskedLatentToVideoPipeline"
    jpipe = getattr(jax_stage2, name)(
        JaxUNet(JaxCfg.tiny(attn_impl=impl, **kw)), up, shared["vae"], shared["vae_params"],
        text_encoder=shared["text"], text_params=shared["text_params"], tokenizer=JaxTok(64, 16),
        unet384=shared["dec"], unet384_params=shared["dec_params"])
    rgba = r.integers(0, 256, (RES, RES, 4)).astype(np.float32)[None, None] / 127.5 - 1.0
    cond = build_rgba_latents(shared["vae"], shared["vae_params"], rgba, shared["enc"],
                              shared["enc_params"])
    mask = np.ones((1, 1, 8, 8, 1), np.float32)
    ts = jpipe.get_timesteps(STEPS)
    latents = jpipe.prepare_init_latents(cond, FRAMES, ts, jax.random.PRNGKey(3), mask=mask)
    call = dict(latents=latents, condition_latent=cond, mask=mask, motion=[5.0], timesteps=ts,
                guidance_scale=9.0)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jpipe(PROMPT, **call)]

    ppipe = getattr(stage2, name)(
        load_into(UNet3DConditionModel(UNet3DConfig.tiny(attn_impl=impl, **kw)),
                  unet3d_state_dict(up)),
        load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(shared["vae_params"])),
        text_encoder=load_into(CLIPTextModel(CLIPTextConfig.tiny()),
                               clip_text_state_dict(shared["text_params"])),
        tokenizer=HashTokenizer(64, 16),
        unet384=load_into(UNet384(UNet384Config.tiny()), unet384_state_dict(shared["dec_params"])))
    got = ppipe(PROMPT, **{k: t(np.asarray(v)) if k in ("latents", "condition_latent", "mask")
                           else v for k, v in call.items()})
    return [n(g) for g in got], want, jpipe, latents


@pytest.mark.parametrize("concat,impl", [(False, "pallas"), (True, "xla")],
                         ids=["masked_pallas", "concat_xla"])
def test_stage2_pipeline_matches_jax(shared, concat, impl):
    (video, latents, rgba), (w_video, w_latents, w_rgba), jpipe, _ = _run(shared, concat, impl)
    assert video.shape == (1, FRAMES, RES, RES, 3) and rgba.shape == (1, FRAMES, RES, RES, 4)
    for got, want in ((latents, w_latents), (video, w_video), (rgba[..., :3], w_rgba[..., :3])):
        np.testing.assert_allclose(got, want, atol=SCALE_TOL * np.abs(want).max())
    # alpha: equal but where JAX's decoder output sits at the threshold
    from animate_anything_tpu.models.transparent_vae import UNet384

    raw = np.asarray(jax.jit(jpipe.unet384.apply)(
        jpipe.unet384_params, w_video.reshape(-1, RES, RES, 3),
        w_latents.reshape(-1, 8, 8, 4) / 0.18215))[..., 3] * 255.0
    assert isinstance(jpipe.unet384, UNet384)
    settled = np.abs(raw - 127.0).reshape(w_rgba.shape[:-1]) > 1e-3
    np.testing.assert_array_equal(rgba[..., 3][settled], w_rgba[..., 3][settled])
    assert settled.mean() > 0.99


def test_main_eval_writes_the_rgba_outputs(tmp_path, monkeypatch):
    """``train_transparent_i2v_stage2 --eval`` on the CPU at the tiny size:
    the gif, the two animated webps (every frame, alpha in {0, 255}) and a
    finite motion score; then the 9-channel Concat pipeline through a
    ``unet/config.json`` with ``condition_mode: channel_concat``."""
    from PIL import Image

    from animate_anything_tpu_torch import cli_stage2, train_transparent_i2v_stage2
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.pipelines import stage2
    from animate_anything_tpu_torch.train.checkpoint import save_pipeline
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--config", os.path.join(repo, "configs/layerdiffuse_stage2_384.yaml"), "--eval",
            "--device", "cpu", "model_size=tiny", f"validation_data.width={RES}",
            f"validation_data.height={RES}", f"validation_data.num_frames={FRAMES}",
            f"validation_data.num_inference_steps={STEPS}"]
    seen = []
    monkeypatch.setattr(cli_stage2, "save_rgba_outputs",
                        lambda d, rgba, _f=cli_stage2.save_rgba_outputs, **k:
                        seen.append((rgba, _f(d, rgba, **k))) or seen[-1][1])
    train_transparent_i2v_stage2.cli(argv + [f"output_dir={tmp_path / 'masked'}"])
    (rgba, out), = seen     # main_eval adds the score to the paths it was given
    assert set(out) == {"gif", "rgba", "alpha", "latent_motion_score"}
    assert np.isfinite(out["latent_motion_score"])
    assert rgba.shape == (1, FRAMES, RES, RES, 4) and set(np.unique(rgba[..., 3])) <= {0, 255}
    for key in ("gif", "rgba", "alpha"):
        with Image.open(out[key]) as im:
            assert im.n_frames == FRAMES and im.size == (RES, RES)
            if key == "alpha":      # PIL's webp is lossy: the binary alpha comes back near
                im.seek(FRAMES - 1)
                got = np.asarray(im.convert("L"), np.float32)
                assert np.abs(got - rgba[0, -1, ..., 3]).mean() < 16

    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True,
                            condition_mode="channel_concat")
    unet = init_unet3d_(UNet3DConditionModel(cfg), torch.Generator().manual_seed(0))
    save_pipeline(str(tmp_path / "concat_ckpt"), unet, cfg)
    with open(tmp_path / "concat_ckpt" / "unet" / "config.json") as f:
        assert json.load(f)["condition_mode"] == "channel_concat"
    built = []
    monkeypatch.setattr(stage2.ConcatLatentToVideoPipeline, "__init__",
                        lambda self, *a, _i=stage2.ConcatLatentToVideoPipeline.__init__, **k:
                        built.append(self) or _i(self, *a, **k))
    res = cli_stage2.main_eval(device="cpu", **dict(
        cli_stage2.load_config(argv[1], overrides=argv[5:]).to_dict(), in_channels=9,
        pretrained_model_path=str(tmp_path / "concat_ckpt"), output_dir=str(tmp_path / "concat")))
    pipe, = built
    assert pipe.unet.config.condition_mode == "channel_concat"
    assert tuple(pipe.unet.conv_in2.weight.shape[:2]) == (32, 9)
    assert np.isfinite(res["latent_motion_score"])
    assert all(os.path.isfile(res[k]) for k in ("gif", "rgba", "alpha"))
