"""The transparent RGBA stage-2 modules of the port against the JAX package's,
on the CPU in fp32: the multi-head ``VAEAttentionBlock``, the LayerDiffuse
pair (``models/transparent_vae.py``: the offset encoder, ``UNet384``,
``build_rgba_latents``, ``decode_rgba_video``) and the UNet's
``condition_mode="channel_concat"`` under all three ``attn_impl`` values.

Each side gets the same numpy-drawn inputs and one ``jax_params`` tree,
carried into the port by ``utils/convert.py`` with ``strict=True``. The
draws are non-zero for every kernel, the zero-initialised ``blocks_16`` and
``latent_conv_in`` included, so the offset and the latent injection take
part. Tolerance 1e-5 absolute on outputs of magnitude ~1 (fp32
summation-order noise through a few layers); the UNets 5e-5, as
``test_torch_port_unet.py``. The port's ``state_dict`` also goes back
through JAX's own torch importers (``convert_unet384``,
``convert_offset_encoder``) to the JAX tree: the reference's torch keys.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

ATOL, UNET_ATOL = 1e-5, 5e-5
UNET384_TINY = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=4, norm_num_groups=2)
# ``UNet3DConfig.tiny`` cut to two levels of one resnet each: the channel
# concat touches only the input conv and the output, every block kind kept
UNET_CUT = dict(block_out_channels=(32, 64), layers_per_block=1,
                down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
                up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("head_dim", [None, 8], ids=["one_head", "head_dim_8"])
def test_vae_attention_block_heads_match_jax(head_dim):
    from animate_anything_tpu.models.vae import VAEAttentionBlock as JaxBlock

    from animate_anything_tpu_torch.models.vae import VAEAttentionBlock
    from animate_anything_tpu_torch.utils.convert import unet384_state_dict

    x = np.random.default_rng(0).standard_normal((2, 6, 5, 32)).astype(np.float32)
    jb = JaxBlock(groups=4, head_dim=head_dim, eps=1e-5)
    params = jax_params(jb, x)
    want = np.asarray(jax.jit(jb.apply)(params, x))
    head = "mid_block.attentions.0."
    sd = {k[len(head):]: v for k, v in unet384_state_dict({"mid_attn": params["params"]}).items()}
    block = load_into(VAEAttentionBlock(32, 4, 1e-5, head_dim=head_dim), sd)
    assert block.heads == (1 if head_dim is None else 4)
    with torch.no_grad():
        got = block(t(x))
    np.testing.assert_allclose(n(got), want, atol=ATOL)
    if head_dim is not None:     # the heads change the result: one head does not match
        with torch.no_grad():
            one = load_into(VAEAttentionBlock(32, 4, 1e-5), sd)(t(x))
        assert float((one - got).abs().max()) > 1e-3


def test_offset_encoder_matches_jax_and_loads_the_reference_keys():
    from animate_anything_tpu.models.transparent_vae import \
        LatentTransparencyOffsetEncoder as JaxEnc
    from animate_anything_tpu.utils.import_torch import convert_offset_encoder

    from animate_anything_tpu_torch.models.transparent_vae import LatentTransparencyOffsetEncoder
    from animate_anything_tpu_torch.utils.convert import offset_encoder_state_dict

    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 40, 4)).astype(np.float32)
    params = jax_params(JaxEnc(), x)
    assert float(np.abs(params["params"]["blocks_16"]["kernel"]).max()) > 0
    want = np.asarray(jax.jit(JaxEnc().apply)(params, x))
    enc = load_into(LatentTransparencyOffsetEncoder(), offset_encoder_state_dict(params))
    assert sorted({k.split(".")[1] for k in enc.state_dict()}, key=int) == [
        str(i) for i in range(0, 17, 2)]
    with torch.no_grad():
        got = enc(t(x))
    assert got.shape == (2, 4, 5, 4)
    np.testing.assert_allclose(n(got), want, atol=ATOL)
    _assert_same_tree(convert_offset_encoder({k: v.numpy() for k, v in enc.state_dict().items()}),
                      params["params"])


@pytest.fixture(scope="module")
def unet384_case():
    from animate_anything_tpu.models.transparent_vae import UNet384 as JaxUNet384
    from animate_anything_tpu.models.transparent_vae import UNet384Config as JaxCfg

    r = np.random.default_rng(2)
    x = r.uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    lat = r.standard_normal((2, 8, 6, 4)).astype(np.float32)
    model = JaxUNet384(JaxCfg(**UNET384_TINY))
    params = jax_params(model, x, lat, seed=3)
    return model, params, x, lat


def _port_unet384(params):
    from animate_anything_tpu_torch.models.transparent_vae import UNet384, UNet384Config
    from animate_anything_tpu_torch.utils.convert import unet384_state_dict

    return load_into(UNet384(UNet384Config.tiny()), unet384_state_dict(params))


def test_unet384_matches_jax_and_loads_the_reference_keys(unet384_case):
    from animate_anything_tpu.utils.import_torch import convert_unet384

    model, params, x, lat = unet384_case
    assert float(np.abs(params["params"]["latent_conv_in"]["kernel"]).max()) > 0
    want = np.asarray(jax.jit(model.apply)(params, x, lat))
    port = _port_unet384(params)
    with torch.no_grad():
        got = port(t(x), t(lat))
        # the injection takes part: a zero latent gives another result
        other = port(t(x), torch.zeros_like(t(lat)))
    assert got.shape == (2, 64, 48, 4)
    np.testing.assert_allclose(n(got), want, atol=ATOL)
    assert float((other - got).abs().max()) > 1e-3
    sd = port.state_dict()
    assert "mid_block.attentions.0.to_out.0.weight" in sd
    assert "down_blocks.3.attentions.1.group_norm.weight" in sd
    assert "up_blocks.0.attentions.2.to_q.weight" in sd
    _assert_same_tree(convert_unet384({k: v.numpy() for k, v in sd.items()}), params["params"])


def test_decode_rgba_video_matches_jax(unet384_case):
    from animate_anything_tpu.models.transparent_vae import decode_rgba_video as jax_decode

    from animate_anything_tpu_torch.models.transparent_vae import decode_rgba_video

    model, params, x, lat = unet384_case
    rgb, latents = x.reshape(1, 2, 64, 48, 3), lat.reshape(1, 2, 8, 6, 4)
    want = np.asarray(jax.jit(lambda p, a, b: jax_decode(model, p, a, b))(params, rgb, latents))
    with torch.no_grad():
        got = decode_rgba_video(_port_unet384(params), t(rgb), t(latents))
    assert got.shape == (1, 2, 64, 48, 4) and got.dtype == torch.float32
    assert set(np.unique(n(got[..., 3]))) <= {0.0, 255.0}
    assert 0 < float((got[..., 3] > 0).float().mean()) < 1
    np.testing.assert_allclose(n(got[..., :3]), want[..., :3], atol=255 * ATOL)
    np.testing.assert_array_equal(n(got[..., 3]), want[..., 3])


def test_build_rgba_latents_matches_jax():
    from animate_anything_tpu.models.transparent_vae import \
        LatentTransparencyOffsetEncoder as JaxEnc
    from animate_anything_tpu.models.transparent_vae import build_rgba_latents as jax_build
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg

    from animate_anything_tpu_torch.models.transparent_vae import (
        LatentTransparencyOffsetEncoder, build_rgba_latents)
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.utils.convert import offset_encoder_state_dict, vae_state_dict

    px = np.random.default_rng(4).uniform(-1, 1, (1, 2, 32, 32, 4)).astype(np.float32)
    vae, enc = JaxVAE(JaxVAECfg.tiny()), JaxEnc()
    vp = jax_params(vae, px[0, :, :, :, :3], seed=5)
    ep = jax_params(enc, px[0], seed=6)
    want = np.asarray(jax_build(vae, vp, px, enc, ep))
    with torch.no_grad():
        got = build_rgba_latents(load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vp)),
                                 t(px), load_into(LatentTransparencyOffsetEncoder(),
                                                  offset_encoder_state_dict(ep)))
    assert got.shape == (1, 2, 4, 4, 4)
    np.testing.assert_allclose(n(got), want, atol=ATOL)


def test_init_transparent_pair_draws_the_flax_initialisers():
    from animate_anything_tpu_torch import cli_stage2

    enc, dec = cli_stage2.build_transparent_vae("tiny", device="cpu")
    sd_e, sd_d = enc.state_dict(), dec.state_dict()
    assert not sd_e["blocks.16.weight"].any() and not sd_e["blocks.16.bias"].any()
    assert not sd_d["latent_conv_in.weight"].any()
    w = sd_e["blocks.2.weight"]                           # fan-in 9·32
    assert abs(float(w.std()) * (9 * 32) ** 0.5 - 1.0) < 0.1
    assert all(bool((v == 1).all()) for k, v in sd_d.items() if k.endswith("norm1.weight"))
    assert not enc.training and not dec.training
    enc2, _ = cli_stage2.build_transparent_vae("tiny", device="cpu", seed=1)
    assert not torch.equal(enc2.state_dict()["blocks.0.weight"], sd_e["blocks.0.weight"])


@pytest.fixture(scope="module")
def concat_case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg

    r = np.random.default_rng(7)
    b, f, hw = 2, 3, 16
    args = (r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), np.int32(611),
            r.standard_normal((b, 7, 32)).astype(np.float32),
            r.standard_normal((b, 1, hw, hw, 4)).astype(np.float32),
            (r.random((b, 1, hw, hw, 1)) > 0.5).astype(np.float32),
            np.array([2.0, 6.0], np.float32))
    kw = dict(motion_mask=True, motion_strength=True, condition_mode="channel_concat", **UNET_CUT)
    params = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **kw)), *args)
    return JaxUNet, JaxCfg, kw, params, args


@pytest.mark.parametrize("impl", ["xla", "pallas", "packed"])
def test_channel_concat_unet_matches_jax(concat_case, impl):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    JaxUNet, JaxCfg, kw, params, args = concat_case
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(JaxUNet(JaxCfg.tiny(attn_impl=impl, **kw)).apply)(params, *args))
    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(attn_impl=impl, **kw)),
                     unet3d_state_dict(params))
    assert tuple(unet.conv_in2.weight.shape[:2]) == (32, 9)   # mask + condition + sample
    with torch.no_grad():
        got = unet(t(args[0]), int(args[1]), *(t(a) for a in args[2:]))
    assert got.shape == want.shape == args[0].shape           # no frame stripped
    np.testing.assert_allclose(n(got), want, atol=UNET_ATOL)
