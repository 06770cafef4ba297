"""The SVD UNet's modules (``models/svd_unet.py``) against the JAX package's
``animate_anything_tpu/models/svd_unet.py``, on the CPU in fp32, and the
UNet's parameter layout.

Each module gets the same numpy-drawn inputs and a ``jax_params`` tree
carried over by ``utils/convert.py::svd_unet_state_dict`` (wrapped under the
UNet path the module has there, so the temporal-conv transposition and the
renames apply) with ``strict=True``. Tolerance 1e-5 absolute on outputs of
magnitude ~1: fp32 summation-order noise through one block. Under
``"pallas"`` JAX's Pallas paths run as its tests run them on the CPU: the
flash kernel in interpret mode, the temporal conv, GEGLU tail and fused
temporal block through their exact twins; the port's wrappers run their
plain versions, and the tests count that the kernel wrappers were the ones
called.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

ATOL = 1e-5


def sub_state_dict(params, *path):
    """A JAX submodule's tree → the port module's state dict: the tree
    wrapped under ``path`` (flax names) of the UNet, exported, and the
    exported path stripped (read off a probe leaf at the same place)."""
    from animate_anything_tpu_torch.utils.convert import svd_unet_state_dict

    tree, probe = params["params"], {"probe": {"bias": np.zeros(1, np.float32)}}
    for name in reversed(path):
        tree, probe = {name: tree}, {name: probe}
    prefix = next(iter(svd_unet_state_dict(probe)))[:-len("probe.bias")]
    sd = svd_unet_state_dict(tree)
    assert all(key.startswith(prefix) for key in sd), prefix
    return {key[len(prefix):]: v for key, v in sd.items()}


@contextlib.contextmanager
def counted(module, name):
    """Count the calls of ``module.name``."""
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, wrapper)
        yield calls


def _run_jax(module, params, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(module.apply, static_argnums=tuple(
            i + 1 for i, a in enumerate(args) if not hasattr(a, "shape")))(params, *args))


def test_timestep_embedding_out_dim_matches_jax():
    from animate_anything_tpu.models.layers import TimestepEmbedding as JaxTE

    from animate_anything_tpu_torch.models.layers import TimestepEmbedding

    x = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    jm = JaxTE(64, out_dim=16)
    p = jax_params(jm, x)
    port = TimestepEmbedding(16, 64, out_dim=16)
    assert port.linear_2.weight.shape == (16, 64)
    load_into(port, sub_state_dict(p, "down_blocks_0_attentions_0", "time_pos_embed"))
    np.testing.assert_allclose(n(port(t(x))), np.asarray(jm.apply(p, x)), atol=ATOL)


def test_alpha_blender_matches_jax_in_both_dtypes():
    import jax.numpy as jnp

    from animate_anything_tpu.models.svd_unet import AlphaBlender as JaxAB

    from animate_anything_tpu_torch.models.svd_unet import AlphaBlender

    r = np.random.default_rng(1)
    a, b = (r.standard_normal((4, 5, 8)).astype(np.float32) for _ in range(2))
    p = {"params": {"mix_factor": np.array([0.8], np.float32)}}
    port = AlphaBlender()
    port.load_state_dict({"mix_factor": torch.tensor([0.8])})
    np.testing.assert_allclose(n(port(t(a), t(b))), np.asarray(JaxAB().apply(p, a, b)),
                               atol=1e-6)
    got = port(t(a).bfloat16(), t(b).bfloat16())
    want = JaxAB().apply(p, jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_temporal_resnet_block_matches_jax(impl):
    from animate_anything_tpu.models.svd_unet import TemporalResnetBlock as JaxTRB

    from animate_anything_tpu_torch.models import svd_unet
    from animate_anything_tpu_torch.ops import temporal_conv

    r = np.random.default_rng(2)
    b, f, hw, c = 2, 4, 3, 64
    x = r.standard_normal((b * f, hw, hw, c)).astype(np.float32)
    temb = r.standard_normal((b * f, 32)).astype(np.float32)
    jm = JaxTRB(c, impl=impl)
    p = jax_params(jm, x, temb, f)
    port = load_into(svd_unet.TemporalResnetBlock(c, 32, impl),
                     sub_state_dict(p, "down_blocks_0_resnets_0", "temporal_res_block"))
    assert port.conv1.weight.shape == (c, c, 3, 1, 1) and port.norm1.eps == 1e-6
    with counted(temporal_conv, "tap_conv") as calls, torch.no_grad():
        got = port(t(x), t(temb), f)
    assert len(calls) == (2 if impl == "pallas" else 0)
    np.testing.assert_allclose(n(got), _run_jax(jm, p, x, temb, f), atol=ATOL)


def test_broadcast_cross_attention_matches_jax_per_batch():
    """Two batches with different contexts (zeros and an embedding, as
    CFG's halves), L = 1 and L = 3 tokens: each batch attends only to its
    own context."""
    from animate_anything_tpu.models.svd_unet import BroadcastCrossAttention as JaxBCA

    from animate_anything_tpu_torch.models.svd_unet import BroadcastCrossAttention

    r = np.random.default_rng(3)
    x = r.standard_normal((2, 3, 5, 32)).astype(np.float32)
    for L in (1, 3):
        ctx = r.standard_normal((2, L, 24)).astype(np.float32)
        ctx[0] = 0.0
        jm = JaxBCA(4, 8, context_dim=24)
        p = jax_params(jm, x, ctx)
        port = load_into(BroadcastCrossAttention(32, 4, 8, 24),
                         sub_state_dict(p, "down_blocks_0_attentions_0", "attn2"))
        with torch.no_grad():
            got = port(t(x), t(ctx))
            other = ctx.copy()
            other[1] = r.standard_normal((L, 24))
            moved = port(t(x), t(other))
        np.testing.assert_allclose(n(got), np.asarray(jm.apply(p, x, ctx)), atol=ATOL)
        np.testing.assert_array_equal(n(moved[0]), n(got[0]))
        assert float((moved[1] - got[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_temporal_basic_transformer_block_matches_jax(impl):
    """Under "pallas" (f = 5, head dim 16, inner == c: JAX's ``fused_ok``
    holds) norm1 + attn1 go through kernel 5's wrapper and both feed-forwards
    through kernel 2's; under "xla" through neither."""
    from animate_anything_tpu.models.svd_unet import TemporalBasicTransformerBlock as JaxTB

    from animate_anything_tpu_torch.models import attention, svd_unet

    r = np.random.default_rng(4)
    x = r.standard_normal((2, 5, 6, 32)).astype(np.float32)
    ctx = r.standard_normal((2, 1, 24)).astype(np.float32)
    ctx[0] = 0.0
    jm = JaxTB(2, 16, context_dim=24, attn_impl=impl)
    p = jax_params(jm, x, ctx)
    port = load_into(svd_unet.TemporalBasicTransformerBlock(32, 2, 16, 24, impl),
                     sub_state_dict(p, "down_blocks_0_attentions_0",
                                    "temporal_transformer_blocks_0"))
    with counted(svd_unet, "temporal_block") as k5, counted(attention, "ln_geglu_ff") as k2, \
            torch.no_grad():
        got = port(t(x), t(ctx))
    assert (len(k5), len(k2)) == ((1, 2) if impl == "pallas" else (0, 0))
    np.testing.assert_allclose(n(got), _run_jax(jm, p, x, ctx), atol=ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_transformer_spatio_temporal_model_matches_jax(impl):
    """16×16 latents (s = 256: the spatial self-attention takes the flash
    kernel under "pallas", in interpret mode on the JAX side), 3 frames,
    CFG's two contexts."""
    from animate_anything_tpu.models.svd_unet import TransformerSpatioTemporalModel as JaxTSTM

    from animate_anything_tpu_torch.models.svd_unet import TransformerSpatioTemporalModel
    from animate_anything_tpu_torch.ops import attention

    r = np.random.default_rng(5)
    f = 3
    x = r.standard_normal((2 * f, 16, 16, 32)).astype(np.float32)
    ctx = r.standard_normal((2, 1, 24)).astype(np.float32)
    ctx[0] = 0.0
    jm = JaxTSTM(2, 16, 24, f, attn_impl=impl)
    p = jax_params(jm, x, ctx)
    port = load_into(TransformerSpatioTemporalModel(32, 2, 16, 24, impl),
                     sub_state_dict(p, "down_blocks_0_attentions_0"))
    with counted(attention, "flash_attention") as k1, torch.no_grad():
        got = port(t(x), t(ctx), f)
    assert len(k1) == (1 if impl == "pallas" else 0)
    np.testing.assert_allclose(n(got), _run_jax(jm, p, x, ctx), atol=ATOL)


def _tiny_jax_params(in_channels=9):
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet

    z = np.zeros((1, 2, 8, 8, in_channels), np.float32)
    return jax_params(JaxUNet(JaxCfg.tiny(in_channels=in_channels, attn_impl="xla")), z,
                      np.float32(0.5), np.zeros((1, 1, 32), np.float32),
                      np.zeros((1, 3), np.float32))


@pytest.mark.parametrize("in_channels", [8, 9])
def test_svd_unet_keys_are_export_svd_unets_and_load_strictly(in_channels):
    from animate_anything_tpu.utils.import_torch import convert_svd_unet, export_svd_unet

    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import svd_unet_state_dict

    p = _tiny_jax_params(in_channels)
    sd = svd_unet_state_dict(p)
    want = export_svd_unet(p)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(n(sd[k]), v, err_msg=k)
    port = UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny(in_channels=in_channels))
    assert set(port.state_dict()) == set(sd)
    load_into(port, sd)
    assert {"down_blocks.0.resnets.1.temporal_res_block.conv2.weight",
            "down_blocks.0.resnets.0.time_mixer.mix_factor",
            "down_blocks.1.attentions.0.time_mixer.mix_factor",
            "mid_block.attentions.0.temporal_transformer_blocks.0.ff_in.net.0.proj.weight",
            "up_blocks.2.upsamplers.0.conv.weight", "down_blocks.0.downsamplers.0.conv.weight",
            "add_embedding.linear_2.bias",
            "up_blocks.1.attentions.2.time_pos_embed.linear_2.weight",
            } <= set(sd)
    assert sd["down_blocks.0.resnets.0.temporal_res_block.conv1.weight"].shape == (32, 32, 3, 1, 1)
    assert sd["conv_in.weight"].shape == (32, in_channels, 3, 3)
    # diffusers → flax through JAX's importer gives the tree back
    back = convert_svd_unet({k: v.numpy() for k, v in sd.items()})
    flat = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(p["params"])[0]}
    flat_back = {jax.tree_util.keystr(k): v
                 for k, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert set(flat) == set(flat_back)
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], np.asarray(v), err_msg=k)


def test_init_svd_unet_draws_the_flax_initialisers():
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import init_svd_unet_

    m = init_svd_unet_(UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny()),
                       torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in m.named_parameters()}
    mixers = [k for k in params if k.endswith("mix_factor")]
    assert len(mixers) == 22 + 16 and all(float(params[k]) == 0.5 for k in mixers)
    assert all(float(p.abs().max()) == 0 for k, p in params.items() if k.endswith(".bias"))
    assert all(bool((p == 1).all()) for k, p in params.items()
               if k.endswith(".weight") and p.ndim == 1)
    w = params["down_blocks.1.resnets.0.temporal_res_block.conv1.weight"]   # fan-in 3·64
    assert abs(float(w.std()) * (3 * 64) ** 0.5 - 1.0) < 0.05


def test_svd_unet_refuses_what_this_slice_does_not_port():
    from animate_anything_tpu_torch.models.svd_unet import SVDUNetConfig

    # gradient checkpointing is ported (its gradients: test_torch_port_svd_train.py)
    assert SVDUNetConfig.tiny(gradient_checkpointing=True).gradient_checkpointing
    with pytest.raises(ValueError, match="attn_impl"):
        SVDUNetConfig.tiny(attn_impl="flash")
    assert SVDUNetConfig().impl == "xla" and SVDUNetConfig(attn_impl="pallas").impl == "pallas"
