"""Kernel 5's plain version and the fused temporal path against the JAX
package, on the CPU.

- ``temporal_block_reference`` against JAX's exact twin ``_reference_bfsc``
  (fp32, atol 1e-5: the same products, summed in another order; bf16 at
  atol 2e-2, one bf16 ulp of the magnitude-4 outputs);
- the same function against the Pallas kernels themselves in interpret
  mode, called directly (off the TPU the JAX wrappers return the twin):
  ``_build_bfsc`` where nblk·p divides s, the packed ``_build`` through
  ``pack_frames``/``unpack_frames`` at a ragged s, and the head-grouped
  ``_build(..., fuse_residual=False)`` partial sum of the c = 1280 sites;
  atol 2e-4, the JAX tests' own tolerance for these kernels;
- ``TemporalTransformer`` against JAX's ``attn_impl="pallas"`` model with
  the gate ``fused_ok`` as it is, on shapes where JAX takes the bfsc
  kernel, the packed kernel (``_bfsc_geometry`` is None), and the
  ``transformer_in`` form (inner width ≠ channels); atol 5e-5 as the
  other module tests.

Inputs and weights come from numpy seeds. JAX weights are (in, out); the
port takes the torch Linear layout (out, in).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, t


def _inputs(f, s, c, seed=0, b=2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, f, s, c)).astype(np.float32)
    lns = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    lnb = (0.1 * r.standard_normal(c)).astype(np.float32)
    ws = [(r.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32) for _ in range(4)]
    bo = (0.1 * r.standard_normal(c)).astype(np.float32)
    return x, lns, lnb, ws, bo


def _port(x, lns, lnb, ws, bo, heads, dtype=torch.float32):
    from animate_anything_tpu_torch.ops.temporal_block import temporal_block

    return temporal_block(t(x).to(dtype), t(lns), t(lnb), *[t(w.T).to(dtype) for w in ws],
                          t(bo), heads=heads)


def _jax_args(lns, lnb, ws, bo, c):
    return (lns.reshape(1, c), lnb.reshape(1, c), *ws, bo.reshape(1, c))


@pytest.mark.parametrize("f,s,c,heads", [(17, 120, 128, 2), (17, 120, 64, 8), (4, 9, 64, 2)],
                         ids=["ragged-d64", "d8", "f4"])
def test_reference_matches_jax_twin(f, s, c, heads):
    from animate_anything_tpu.ops.temporal_block import _reference_bfsc

    x, lns, lnb, ws, bo = _inputs(f, s, c)
    want = _reference_bfsc(x, *_jax_args(lns, lnb, ws, bo, c), heads=heads, d=c // heads)
    got = _port(x, lns, lnb, ws, bo, heads)
    assert got.shape == x.shape
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_reference_matches_jax_twin_bf16():
    from animate_anything_tpu.ops.temporal_block import _reference_bfsc

    f, s, c, heads = 17, 120, 128, 2
    x, lns, lnb, ws, bo = _inputs(f, s, c, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    wsb = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    want = _reference_bfsc(xb, lns.reshape(1, c), lnb.reshape(1, c), *wsb, bo.reshape(1, c),
                           heads=heads, d=c // heads)
    got = _port(x, lns, lnb, ws, bo, heads, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), atol=2e-2)


def test_reference_matches_bfsc_pallas_kernel():
    """``_build_bfsc`` at s = 112 = nblk·p, where the kernel reads no
    location past s."""
    from animate_anything_tpu.ops.temporal_block import _bfsc_geometry, _build_bfsc

    f, s, c, heads = 17, 112, 128, 2
    p, _, _, nblk = _bfsc_geometry(f, s, c)
    assert s % (nblk * p) == 0
    x, lns, lnb, ws, bo = _inputs(f, s, c, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = _build_bfsc(f, s, heads, c // heads, c, 1e-5)(x, *_jax_args(lns, lnb, ws, bo, c))
    np.testing.assert_allclose(n(_port(x, lns, lnb, ws, bo, heads)), np.asarray(want),
                               atol=2e-4)


def test_reference_matches_packed_pallas_kernel():
    """The packed ``_build`` at a ragged s (120 = 17 packs of 7 + 1): the
    packing pads the edge with zero rows in device memory."""
    from animate_anything_tpu.ops.temporal_block import (_build, pack_frames, pack_geometry,
                                                         unpack_frames)

    f, s, c, heads = 17, 120, 128, 2
    geom = pack_geometry(f, s)
    assert geom.s_pad != s
    x, lns, lnb, ws, bo = _inputs(f, s, c, seed=3)
    with pltpu.force_tpu_interpret_mode():
        yp = _build(geom, heads, c // heads, c, 1e-5)(pack_frames(jnp.asarray(x), geom),
                                                      *_jax_args(lns, lnb, ws, bo, c))
    want = unpack_frames(yp, geom)
    np.testing.assert_allclose(n(_port(x, lns, lnb, ws, bo, heads)), np.asarray(want),
                               atol=2e-4)


def test_reference_matches_head_grouped_pallas_kernel():
    """The c = 1280 form: per-head-group kernels without bias and residual,
    summed outside (``_build_vjp``); the port computes all heads at once."""
    from animate_anything_tpu.ops import temporal_block as tb

    f, s, c, heads, d = 5, 12, 256, 4, 64
    geom = tb.pack_geometry(f, s)
    x, lns, lnb, ws, bo = _inputs(f, s, c, seed=4)
    lns_, lnb_, wq, wk, wv, wo, bo_ = _jax_args(lns, lnb, ws, bo, c)
    xp = tb.pack_frames(jnp.asarray(x), geom)
    hg = heads // 2
    with pltpu.force_tpu_interpret_mode():
        part = tb._build(geom, hg, d, c, 1e-5, fuse_residual=False)
        acc = 0.0
        for gi in range(2):
            sl = slice(gi * hg * d, (gi + 1) * hg * d)
            acc = acc + part(xp, lns_, lnb_, wq[:, sl], wk[:, sl], wv[:, sl], wo[sl, :],
                             bo_).astype(jnp.float32)
    want = tb.unpack_frames((acc + bo_ + xp.astype(jnp.float32)).astype(xp.dtype), geom)
    np.testing.assert_allclose(n(_port(x, lns, lnb, ws, bo, heads)), np.asarray(want),
                               atol=2e-4)


def test_gate_matches_jax():
    """The port's ``fused_ok`` answers as JAX's on the UNet's sites and
    around its edges: it picks the GELU form of the temporal feed-forward."""
    from animate_anything_tpu.ops import temporal_block as jtb
    from animate_anything_tpu_torch.ops import temporal_block as ptb

    cases = [(f, heads * d, heads, d) for f in (1, 2, 4, 17, 128, 129)
             for heads, d in ((8, 64), (5, 64), (10, 64), (20, 64), (4, 8), (3, 12), (32, 64),
                              (40, 64), (2, 1024 + 64))]
    cases += [(17, 320, 8, 64)]   # heads·d ≠ c
    for case in cases:
        assert ptb.fused_ok(*case) == jtb.fused_ok(*case), case
    assert ptb.fused_ok(17, 512, 8, 64) and ptb.fused_ok(17, 1280, 20, 64)


@pytest.mark.parametrize("channels,heads,d,hw,geometry", [
    (64, 2, 32, (7, 8), "bfsc"),
    (64, 2, 32, (4, 6), "packed"),
    (32, 8, 8, (7, 8), "transformer_in"),
], ids=["bfsc", "packed", "transformer_in"])
def test_fused_temporal_transformer_matches_jax(channels, heads, d, hw, geometry):
    from animate_anything_tpu.models.attention import TemporalTransformer as JaxTT
    from animate_anything_tpu.ops.temporal_block import bfsc_ok, fused_ok
    from animate_anything_tpu_torch.models.attention import TemporalTransformer
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    f, inner = 17, heads * d
    assert fused_ok(f, inner, heads, d)
    assert bfsc_ok(f, hw[0] * hw[1], inner, heads, d) == (geometry != "packed")
    r = np.random.default_rng(5)
    x = r.standard_normal((2 * f, *hw, channels)).astype(np.float32)
    p = jax_params(JaxTT(heads, d, attn_impl="xla"), x, f)
    want, want_sums = JaxTT(heads, d, attn_impl="pallas").apply(p, x, f, None, None, True)
    port = load_into(TemporalTransformer(channels, heads, d), unet3d_state_dict(p["params"]))
    with torch.no_grad():
        got, sums = port(t(x), f)
    np.testing.assert_allclose(n(got), n(want), atol=5e-5)
    np.testing.assert_allclose(n(sums[0]), n(want_sums[0]), rtol=1e-5, atol=1e-3)


def test_head_dims_past_kernel_5_run_the_composite_attention_on_the_fused_path():
    """c = 640 with 2 heads (d = 320): JAX's gate ``fused_ok`` sends it to its
    fused block, kernel 5 does not take d > 256 (``kernel_ok``). The port's
    temporal transformer then runs each LN + frame attention + out-projection
    as the composite does, on the CPU as on the card (a shape gate, not a
    fallback), and keeps the fused tail (kernel 2, tanh GELU): the same
    function as JAX's fused block, held at the module tests' 5e-5."""
    from unittest import mock

    from animate_anything_tpu.models.attention import TemporalTransformer as JaxTT
    from animate_anything_tpu.ops.temporal_block import fused_ok
    from animate_anything_tpu_torch.models import attention
    from animate_anything_tpu_torch.models.attention import TemporalTransformer
    from animate_anything_tpu_torch.ops import temporal_block as ptb
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    f, c, heads = 4, 640, 2
    d = c // heads
    assert fused_ok(f, c, heads, d) and ptb.fused_ok(f, c, heads, d)
    assert not ptb.kernel_ok(f, c, heads) and ptb.kernel_ok(f, c, 4)
    r = np.random.default_rng(9)
    x = r.standard_normal((2 * f, 2, 3, c)).astype(np.float32)
    p = jax_params(JaxTT(heads, d, attn_impl="xla"), x, f)
    want, want_sums = JaxTT(heads, d, attn_impl="pallas").apply(p, x, f, None, None, True)
    port = load_into(TemporalTransformer(c, heads, d), unet3d_state_dict(p["params"]))
    with mock.patch.object(attention, "temporal_block", wraps=attention.temporal_block) as k5, \
            mock.patch.object(attention, "ln_geglu_ff", wraps=attention.ln_geglu_ff) as tail, \
            torch.no_grad():
        got, sums = port(t(x), f)
    assert k5.call_count == 0 and tail.call_count == 1
    np.testing.assert_allclose(n(got), n(want), atol=5e-5)
    np.testing.assert_allclose(n(sums[0]), n(want_sums[0]), rtol=1e-5, atol=1e-3)
