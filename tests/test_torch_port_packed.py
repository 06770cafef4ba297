"""The port in the JAX package's ``attn_impl="xla"`` and ``"packed"``
configurations against the JAX package, on the CPU, in fp32.

- Kernel 9's plain version against JAX's packed Pallas kernel
  (``_temporal_attention_p``) in interpret mode, at f ∈ {2, 14, 17} with
  locations that do not fill the last pack and at head dims 160 and 256;
  atol 2e-5, the JAX test's own.
- The ``temporal_attention`` gate against JAX's, case by case up to
  d = 256, and the port's own clause above it (the einsum form).
- The composite modules (``TemporalConvLayer`` and ``TemporalTapConv``, the
  spatial and temporal transformers) and the tiny mask+motion UNet under
  each configuration against JAX's with the same ``attn_impl``; atol 5e-5,
  fp32 accumulation-order noise (as ``test_torch_port_unet.py``).

Off the TPU JAX's gate keeps its einsum form, and so does the port's off
CUDA. ``packed_on_cpu`` lets both gates admit CPU arrays, so that the
``"packed"`` cases compare JAX's Pallas kernel (interpret mode) with the
port's kernel wrapper on its plain version, and counts the calls on both
sides: a ``"packed"`` case whose counts stayed at zero would compare the
einsum form with itself.
"""

import contextlib
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, port_state_dict, t

ATOL = 5e-5
KERNEL_ATOL = 2e-5


class _OnTpu:
    """``jax`` as JAX's ``ops/temporal_attention.py`` sees it, its device a
    TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices():
        return [types.SimpleNamespace(platform="tpu")]


@contextlib.contextmanager
def packed_on_cpu():
    """Both gates admit CPU arrays; yields the call counters of JAX's
    ``_temporal_attention_p`` and the port's ``packed_temporal_attention``."""
    from animate_anything_tpu.ops import temporal_attention as jta
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    gate = ta.packed_ok
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        mp.setattr(jta, "jax", _OnTpu())
        mp.setattr(ta, "packed_ok", lambda shape, impl, on_cuda: gate(shape, impl, True))
        calls = {"jax": stack.enter_context(mock.patch.object(
                     jta, "_temporal_attention_p", wraps=jta._temporal_attention_p)),
                 "port": stack.enter_context(mock.patch.object(
                     ta, "packed_temporal_attention", wraps=ta.packed_temporal_attention))}
        stack.enter_context(pltpu.force_tpu_interpret_mode())
        yield calls


def _count(calls) -> dict:
    return {k: m.call_count for k, m in calls.items()}


def _impl_context(impl: str):
    return packed_on_cpu() if impl == "packed" else contextlib.nullcontext({})


@pytest.mark.parametrize("shape", [(1, 17, 33, 2, 64), (2, 14, 40, 1, 32), (2, 2, 40, 1, 32),
                                   (1, 17, 12, 1, 160), (1, 17, 12, 1, 256)],
                         ids=["f17", "f14", "f2", "d160", "d256"])
def test_temporal_attention_plain_matches_packed_pallas(shape):
    from animate_anything_tpu.ops.temporal_attention import _temporal_attention_p
    from animate_anything_tpu_torch.ops.temporal_attention import (packed_temporal_attention,
                                                                   temporal_attention_reference)

    r = np.random.default_rng(shape[1])
    q, k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_temporal_attention_p(q, k, v))
    for fn in (temporal_attention_reference, packed_temporal_attention):
        with torch.no_grad():
            got = fn(t(q), t(k), t(v))
        np.testing.assert_allclose(n(got), want, atol=KERNEL_ATOL)


GATE_CASES = [
    ("packed", (2, 17, 256, 1, 64)),    # 512 locations·heads: the threshold
    ("packed", (1, 17, 33, 2, 64)),     # 66
    ("xla", (2, 17, 256, 1, 64)),
    ("pallas", (2, 17, 256, 1, 64)),
    ("packed", (2, 1, 256, 1, 64)),     # f < 2
    ("packed", (1, 129, 8, 1, 64)),     # f > 128
    ("packed", (1, 128, 512, 1, 64)),
    ("packed", (2, 17, 256, 1, 36)),    # d % 8
    ("packed", (2, 17, 4096, 8, 64)),   # transformer_in at full width
    ("packed", (2, 17, 64, 20, 64)),    # the 8x8 level: 2560
    ("packed", (2, 17, 16, 8, 8)),      # the tiny UNet's 4x4 level: 256
    ("packed", (2, 17, 256, 1, 128)),   # head dims up to kernel 9's 256
    ("packed", (2, 17, 256, 1, 160)),
    ("packed", (2, 17, 256, 1, 256)),
]


@pytest.mark.parametrize("impl,shape", GATE_CASES)
def test_temporal_attention_gate_matches_jax(impl, shape):
    from animate_anything_tpu.ops import temporal_attention as jta
    from animate_anything_tpu_torch.ops.temporal_attention import packed_ok

    q = types.SimpleNamespace(shape=shape)   # the gate reads shapes only
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jta, "jax", _OnTpu())
        mp.setattr(jta, "_temporal_attention_p", lambda *a: "kernel")
        mp.setattr(jta, "_einsum_reference", lambda *a: "einsum")
        want = jta.temporal_attention(q, q, q, impl=impl) == "kernel"
    assert packed_ok(shape, impl, on_cuda=True) == want
    assert not packed_ok(shape, impl, on_cuda=False)


@pytest.mark.parametrize("d", [264, 320])
def test_temporal_attention_gate_keeps_the_einsum_form_past_the_kernel(d):
    """The port's one clause of its own: JAX's packed kernel takes d > 256,
    kernel 9 does not, so the port's gate keeps the einsum form there (the
    same function)."""
    from animate_anything_tpu.ops import temporal_attention as jta
    from animate_anything_tpu_torch.ops.temporal_attention import MAX_HEAD_DIM, packed_ok

    shape = (2, 17, 256, 1, d)
    q = types.SimpleNamespace(shape=shape)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jta, "jax", _OnTpu())
        mp.setattr(jta, "_temporal_attention_p", lambda *a: "kernel")
        mp.setattr(jta, "_einsum_reference", lambda *a: "einsum")
        assert jta.temporal_attention(q, q, q, impl="packed") == "kernel"
    assert d > MAX_HEAD_DIM == 256
    assert not packed_ok(shape, "packed", on_cuda=True)


def test_temporal_tap_conv_matches_jax():
    from animate_anything_tpu.models.layers import TemporalTapConv as JaxTap
    from animate_anything_tpu_torch.models.layers import TemporalTapConv

    r = np.random.default_rng(4)
    h = r.standard_normal((2, 5, 12, 32)).astype(np.float32)
    jm = JaxTap(48)
    p = jax_params(jm, h)
    port = TemporalTapConv(32, 48)
    w = np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1)[..., None]   # (O, I, 3, 1, 1)
    load_into(port, {"weight": t(w), "bias": t(p["params"]["bias"])})
    with torch.no_grad():
        got = port(t(h))
    np.testing.assert_allclose(n(got), n(jm.apply(p, h)), atol=ATOL)


@pytest.mark.parametrize("with_sums", [False, True])
def test_temporal_conv_layer_composite_matches_jax(with_sums):
    """Four GroupNorm+SiLU → tap-conv stages; stage 1 on the producer's sums
    when there are any; no output sums on either side."""
    from animate_anything_tpu.models.layers import TemporalConvLayer as JaxTConv
    from animate_anything_tpu_torch.models.layers import TemporalConvLayer

    r = np.random.default_rng(5)
    f = 5
    x = r.standard_normal((2 * f, 4, 4, 64)).astype(np.float32)
    x2 = x.reshape(2 * f, -1, 64).astype(np.float64)
    sums = (x2.sum(1).astype(np.float32), (x2 * x2).sum(1).astype(np.float32)) \
        if with_sums else None
    jm = JaxTConv(64, impl="xla")
    p = jax_params(jm, x, f)
    want, want_sums = jm.apply(p, x, f, True, True,
                               None if sums is None else tuple(map(jnp.asarray, sums)))
    port = load_into(TemporalConvLayer(64, impl="xla"), port_state_dict(p, "temp_convs_0"))
    with torch.no_grad():
        got, got_sums = port(t(x), f, None if sums is None else tuple(map(t, sums)))
    assert want_sums is None and got_sums is None
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


@pytest.mark.parametrize("impl", ["xla", "packed"])
def test_spatial_transformer_matches_jax(impl):
    from animate_anything_tpu.models.attention import SpatialTransformer as JaxST
    from animate_anything_tpu_torch.models.attention import SpatialTransformer

    r = np.random.default_rng(2)
    c, heads, d = 128, 2, 64
    x = r.standard_normal((2, 16, 16, c)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 32)).astype(np.float32)
    p = jax_params(JaxST(heads, d, 32, attn_impl="xla"), x, ctx)
    want, want_sums = JaxST(heads, d, 32, attn_impl=impl).apply(p, x, ctx, None, None, True)
    port = load_into(SpatialTransformer(c, heads, d, 32, attn_impl=impl), port_state_dict(p))
    with torch.no_grad():
        got, sums = port(t(x), t(ctx))
    assert want_sums is None and sums is None
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


@pytest.mark.parametrize("heads,c", [(2, 64), (8, 32)])   # (8, 32): transformer_in, k ≠ c
@pytest.mark.parametrize("impl", ["xla", "packed"])
def test_temporal_transformer_matches_jax(impl, heads, c):
    from animate_anything_tpu.models.attention import TemporalTransformer as JaxTT
    from animate_anything_tpu_torch.models.attention import TemporalTransformer

    r = np.random.default_rng(3)
    f, d = 5, 8 if c == 32 else 32
    x = r.standard_normal((2 * f, 16, 16, c)).astype(np.float32)   # 2·256·heads ≥ 512
    p = jax_params(JaxTT(heads, d, attn_impl="xla"), x, f)
    port = load_into(TemporalTransformer(c, heads, d, attn_impl=impl), port_state_dict(p))
    with _impl_context(impl) as calls:
        want, want_sums = jax.jit(lambda *a: JaxTT(heads, d, attn_impl=impl).apply(
            *a, None, None, True), static_argnums=2)(p, x, f)
        with torch.no_grad():
            got, sums = port(t(x), f)
        counts = _count(calls)
    if impl == "packed":   # two frame attentions, each through the kernel path
        assert counts == {"jax": 2, "port": 2}, counts
    assert want_sums is None and sums is None
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_with_attn_impl_shares_the_weights():
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig

    unet = UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True)).eval()
    other = unet.with_attn_impl("packed")
    assert other.config.attn_impl == "packed" and not other.training
    assert other.up_blocks[3].temp_attentions[0].attn_impl == "packed"
    mine, theirs = dict(unet.named_parameters()), dict(other.named_parameters())
    assert mine.keys() == theirs.keys()
    assert all(mine[k].data_ptr() == theirs[k].data_ptr() for k in mine)


@pytest.mark.parametrize("impl", ["bogus", "", "PALLAS"])
def test_unet_config_rejects_unknown_attn_impl(impl):
    from animate_anything_tpu_torch.models import UNet3DConfig

    with pytest.raises(ValueError, match="attn_impl"):
        UNet3DConfig(attn_impl=impl)


def _unet_args():
    r = np.random.default_rng(0)
    b, f, hw = 2, 3, 16
    return (r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), np.int32(721),
            r.standard_normal((b, 77, 32)).astype(np.float32),
            r.standard_normal((b, 1, hw, hw, 4)).astype(np.float32),
            (r.random((b, 1, hw, hw, 1)) > 0.5).astype(np.float32),
            np.array([2.0, 8.0], np.float32))


# The tiny UNet's temporal transformers whose b·s·h passes the gate: at
# 16x16 latents transformer_in, down 0-1 (2 each) and up 2-3 (3 each), two
# frame attentions each.
TINY_PACKED_CALLS = 2 * (1 + 2 + 2 + 3 + 3)


@pytest.mark.parametrize("impl", ["packed", "xla"])
def test_tiny_unet_forward_matches_jax(impl):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.utils.import_torch import export_unet3d
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig

    args = _unet_args()
    cfg = dict(motion_mask=True, motion_strength=True)
    params = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **cfg)), *args)
    model = JaxUNet(JaxCfg.tiny(attn_impl=impl, **cfg))
    port = load_into(UNet3DConditionModel(UNet3DConfig.tiny(attn_impl=impl, **cfg)),
                     {k: t(w) for k, w in export_unet3d(params).items()})
    with _impl_context(impl) as calls:
        # a fresh function, so that no trace made outside this context is reused
        want = np.asarray(jax.jit(lambda *a: model.apply(*a))(params, *args))
        with torch.no_grad():
            got = port(t(args[0]), int(args[1]), t(args[2]), t(args[3]), t(args[4]),
                       t(args[5]))
        counts = _count(calls)
    if impl == "packed":
        assert counts == {"jax": TINY_PACKED_CALLS, "port": TINY_PACKED_CALLS}, counts
    assert got.shape == want.shape == args[0].shape
    np.testing.assert_allclose(n(got), want, atol=ATOL)


@pytest.mark.slow
def test_two_step_pipeline_packed_matches_jax():
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
    jpipe = JaxPipeline(JaxUNet(JaxCfg.tiny(attn_impl="packed", **cfg)), uparams, vae, vparams)
    jpipe.encode_prompt = lambda prompt, negative_prompt="": (jnp.asarray(pe), jnp.asarray(ne))
    unet = UNet3DConditionModel(UNet3DConfig.tiny(attn_impl="packed", **cfg))
    pipe = LatentToVideoPipeline(load_into(unet, unet3d_state_dict(uparams)),
                                 load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(vparams)))
    pipe.encode_prompt = lambda prompt, negative_prompt="": (t(pe), t(ne))
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (1, frames, res // 8, res // 8, 4), jnp.float32))
    req = dict(mask_img=mask, motion_strength=6.0, num_frames=frames,
               num_inference_steps=steps, guidance_scale=9.0)
    with packed_on_cpu() as calls:
        want_video, want_latents = jpipe.animate_image(image, "", rng=key, **req)
        video, latents = pipe.animate_image(image, "", noise=t(noise), **req)
        counts = _count(calls)
    assert counts["jax"] > 0 and counts["port"] == steps * TINY_PACKED_CALLS, counts
    want_latents = np.asarray(want_latents)
    np.testing.assert_allclose(n(latents), want_latents, atol=2e-5 * np.abs(want_latents).max())
    np.testing.assert_allclose(n(video), np.asarray(want_video), atol=2e-4)
