"""The port's modules against the JAX package's, on the CPU, in fp32.

One numpy-drawn JAX param tree drives both sides: it is carried into the
port by ``utils/convert.py`` and loaded with ``strict=True``. The JAX side
runs its ``attn_impl="pallas"`` path (the Pallas kernels in interpret mode);
the temporal-transformer cases here pin both sides to the composite path
through ``fused_ok`` (the fused path is held in
``test_torch_port_temporal_block.py``). Tolerance 5e-5 absolute: fp32
accumulation-order noise through a few stacked matmuls on magnitude-1
activations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_port_helpers as helpers
from test_torch_port_helpers import jax_params, load_into, n, t

ATOL = 5e-5


@pytest.fixture
def composite_temporal():
    with helpers.composite_temporal():
        yield


def _sd(params, prefix: str = ""):
    """JAX subtree → port state dict; ``prefix`` wraps the tree under a parent
    name (the temporal-conv renames key on ``temp_convs``) and is stripped."""
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    tree = params["params"]
    if not prefix:
        return unet3d_state_dict(tree)
    sd = unet3d_state_dict({prefix: tree})
    head = prefix.replace("_", ".") + "."
    return {k[len(head):]: v for k, v in sd.items()}


def test_resnet_block_matches_jax():
    from animate_anything_tpu.models.layers import ResnetBlock2D as JaxResnet
    from animate_anything_tpu_torch.models.layers import ResnetBlock2D

    r = np.random.default_rng(0)
    x = r.standard_normal((4, 8, 8, 32)).astype(np.float32)
    temb = r.standard_normal((4, 64)).astype(np.float32)
    jm = JaxResnet(64, groups=8)
    p = jax_params(jm, x, temb)
    port = load_into(ResnetBlock2D(32, 64, 64, groups=8), _sd(p))
    with torch.no_grad():
        got = port(t(x), t(temb))
    np.testing.assert_allclose(n(got), n(jm.apply(p, x, temb)), atol=ATOL)


def test_temporal_conv_layer_matches_jax():
    from animate_anything_tpu.models.layers import TemporalConvLayer as JaxTConv
    from animate_anything_tpu_torch.models.layers import TemporalConvLayer

    r = np.random.default_rng(1)
    f = 5
    x = r.standard_normal((2 * f, 4, 4, 64)).astype(np.float32)
    jm = JaxTConv(64, impl="pallas")
    p = jax_params(jm, x, f)       # conv4 drawn non-zero, so the last stage counts
    port = load_into(TemporalConvLayer(64), _sd(p, "temp_convs_0"))
    with torch.no_grad():
        got, sums = port(t(x), f)
    np.testing.assert_allclose(n(got), n(jm.apply(p, x, f)), atol=ATOL)
    yf = n(got).reshape(2 * f, -1, 64)
    np.testing.assert_allclose(n(sums[0]), yf.sum(1), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(n(sums[1]), (yf * yf).sum(1), rtol=1e-5, atol=1e-3)


def test_spatial_transformer_matches_jax():
    from animate_anything_tpu.models.attention import SpatialTransformer as JaxST
    from animate_anything_tpu_torch.models.attention import SpatialTransformer

    r = np.random.default_rng(2)
    c, heads, d = 128, 2, 64
    x = r.standard_normal((2, 16, 16, c)).astype(np.float32)      # s = 256: flash path
    ctx = r.standard_normal((2, 77, 32)).astype(np.float32)
    p = jax_params(JaxST(heads, d, 32, attn_impl="xla"), x, ctx)
    jm = JaxST(heads, d, 32, attn_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        want, want_sums = jm.apply(p, x, ctx, None, None, True)
    port = load_into(SpatialTransformer(c, heads, d, 32), _sd(p))
    with torch.no_grad():
        got, sums = port(t(x), t(ctx))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)
    np.testing.assert_allclose(n(sums[0]), n(want_sums[0]), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(n(sums[1]), n(want_sums[1]), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("heads,c", [(2, 64), (8, 32)])   # (8, 32): transformer_in, k ≠ c
def test_temporal_transformer_matches_jax(composite_temporal, heads, c):
    from animate_anything_tpu.models.attention import TemporalTransformer as JaxTT
    from animate_anything_tpu_torch.models.attention import TemporalTransformer

    r = np.random.default_rng(3)
    f, d = 5, 8 if c == 32 else 32
    x = r.standard_normal((2 * f, 4, 4, c)).astype(np.float32)
    p = jax_params(JaxTT(heads, d, attn_impl="xla"), x, f)
    want, want_sums = JaxTT(heads, d, attn_impl="pallas").apply(p, x, f, None, None, True)
    port = load_into(TemporalTransformer(c, heads, d), _sd(p))
    with torch.no_grad():
        got, sums = port(t(x), f)
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)
    np.testing.assert_allclose(n(sums[0]), n(want_sums[0]), rtol=1e-5, atol=1e-3)


def test_vae_encode_decode_matches_jax():
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxCfg
    from animate_anything_tpu.models.vae import decode_video as jax_decode
    from animate_anything_tpu.models.vae import encode_video as jax_encode
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig, decode_video, \
        encode_video
    from animate_anything_tpu_torch.utils.convert import vae_state_dict

    r = np.random.default_rng(4)
    pixels = r.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    jv = JaxVAE(JaxCfg.tiny())
    p = jax_params(jv, jnp.zeros((1, 32, 32, 3)))
    port = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(p))
    want_z = jax_encode(jv, p, pixels)
    want_x = jax_decode(jv, p, want_z)
    with torch.no_grad():
        z = encode_video(port, t(pixels))
        x = decode_video(port, t(want_z))
        x_chunked = decode_video(port, t(want_z), chunk_size=1)
    np.testing.assert_allclose(n(z), n(want_z), atol=ATOL)
    np.testing.assert_allclose(n(x), n(want_x), atol=ATOL)
    np.testing.assert_allclose(n(x_chunked), n(x), atol=1e-6)
