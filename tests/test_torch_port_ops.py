"""The port's kernel modules and ops against the JAX package, on the CPU.

For each of the four kernel modules the port's plain version (what its
wrapper runs for CPU tensors) is held against the JAX kernel's XLA twin and
against the Pallas kernel itself under ``pltpu.force_tpu_interpret_mode()``,
on the same numpy-made inputs, in fp32. Tolerances are the JAX package's own
for the same kernels (tests/test_ops.py): 2e-5 / 3e-5 absolute on outputs of
magnitude ~1, fp32 accumulation-order noise; sums rtol 2e-5 / atol 1e-3
(sums over up to a few hundred rows of magnitude-1 values).
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import n, t


def _rng(seed):
    return np.random.default_rng(seed)


# ---- kernel 1: flash attention ---------------------------------------------

@pytest.mark.parametrize("h", [1, 2, 5])   # odd h: the TPU kernel's ragged head pair
def test_flash_plain_matches_jax_lanes_kernel(h):
    from animate_anything_tpu.ops.flash_attention import _flash_forward_lanes, _xla_reference
    from animate_anything_tpu_torch.ops.flash_attention import flash_attention

    r = _rng(h)
    q = r.standard_normal((2, 256, h, 64)).astype(np.float32)
    k = r.standard_normal((2, 300, h, 64)).astype(np.float32)   # ragged K
    v = r.standard_normal((2, 300, h, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = _flash_forward_lanes(q, k, v)
    got = flash_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), n(want_kernel), atol=2e-5)
    np.testing.assert_allclose(n(got), n(_xla_reference(q, k, v)), atol=2e-5)


def test_flash_plain_matches_jax_folded_kernel_small_head_dim():
    from animate_anything_tpu.ops.flash_attention import _flash_forward, _xla_reference
    from animate_anything_tpu_torch.ops.flash_attention import flash_attention

    r = _rng(3)
    q = r.standard_normal((2, 130, 3, 8)).astype(np.float32)
    k = r.standard_normal((2, 200, 3, 8)).astype(np.float32)
    v = r.standard_normal((2, 200, 3, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = _flash_forward(q, k, v)
    got = flash_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), n(want_kernel), atol=2e-5)
    np.testing.assert_allclose(n(got), n(_xla_reference(q, k, v)), atol=2e-5)


@pytest.mark.parametrize("sq,sk", [(256, 77), (64, 64), (256, 256)])
def test_attention_dispatch_matches_jax(sq, sk):
    """Short K (cross-attention over 77 tokens) and short q go plain, long
    self-attention goes to the kernel — the JAX routing, same numbers."""
    from animate_anything_tpu.ops.flash_attention import flash_attention as jax_flash
    from animate_anything_tpu_torch.ops.attention import attention

    r = _rng(sq + sk)
    q = r.standard_normal((2, sq, 2, 64)).astype(np.float32)
    kv = r.standard_normal((2, sk, 2, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(q, kv, kv)
    np.testing.assert_allclose(n(attention(t(q), t(kv), t(kv))), n(want), atol=2e-5)


@pytest.mark.parametrize("d", [96, 256])
def test_flash_plain_matches_jax_folded_kernel_new_head_dims(d):
    """Head sizes the kernel took on since its wgmma redesign, ragged against
    its 128-row query and 64-key tiles, against ``_flash_forward``."""
    from animate_anything_tpu.ops.flash_attention import _flash_forward, _xla_reference
    from animate_anything_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention

    assert d in HEAD_DIMS
    r = _rng(d)
    q = r.standard_normal((2, 140, 2, d)).astype(np.float32)
    k = r.standard_normal((2, 200, 2, d)).astype(np.float32)
    v = r.standard_normal((2, 200, 2, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = _flash_forward(q, k, v)
    got = flash_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), n(want_kernel), atol=2e-5)
    np.testing.assert_allclose(n(got), n(_xla_reference(q, k, v)), atol=2e-5)


# (head dim, a gradient is needed, kernel 1 takes it): the backward takes
# every head size the forward does, so a gradient narrows nothing.
KERNEL_GATE_CASES = [
    (64, False, True), (64, True, True), (16, False, True), (16, True, True),
    (96, False, True), (96, True, True),
    (128, True, True), (256, False, True), (240, False, True),
    (40, False, False), (8, False, False),    # d % 16 == 8: JAX's kernel takes them
    (272, False, False), (512, False, False),  # past 256: the VAE's single head
]


@pytest.mark.parametrize("d,needs_grad,want", KERNEL_GATE_CASES)
def test_flash_kernel_gate(d, needs_grad, want):
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops.flash_attention import kernel_ok

    assert kernel_ok((2, 256, 3, d), (2, 300, 3, d)) == want
    if needs_grad:
        assert set(fa.BWD_HEAD_DIMS) == set(fa.HEAD_DIMS)


def _fake(d, device, requires_grad=False):
    """What ``attention`` reads of a (2, 256, 3, d) tensor on ``device``."""
    return types.SimpleNamespace(shape=(2, 256, 3, d), device=torch.device(device),
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("d,requires_grad,device,route", [
    (64, False, "cuda", "kernel"), (64, True, "cuda", "kernel"), (96, False, "cuda", "kernel"),
    (96, True, "cuda", "kernel"), (40, False, "cuda", "sdpa"), (320, False, "cuda", "sdpa"),
    (40, False, "cpu", "kernel"), (320, True, "cpu", "kernel"),   # CPU: the wrapper's plain version
])
def test_attention_routes_head_sizes_by_the_kernel_gate(d, requires_grad, device, route,
                                                         monkeypatch):
    from animate_anything_tpu_torch.ops import attention as attn

    monkeypatch.setattr(attn, "flash_attention", lambda q, k, v: "kernel")
    monkeypatch.setattr(attn, "xla_attention", lambda q, k, v, is_causal=False: "sdpa")
    x = _fake(d, device, requires_grad)
    with torch.enable_grad():
        assert attn.attention(x, x, x, impl="pallas") == route


# Kernel 9's gate: JAX's packed kernel takes every d % 8 == 0; the port's
# kernel stops at MAX_HEAD_DIM = 256, and its gate keeps the einsum form above it.
@pytest.mark.parametrize("d,want", [(64, True), (128, True), (40, True), (136, True),
                                    (256, True), (36, False), (264, False), (320, False)])
def test_packed_gate_refuses_head_dims_past_the_kernel(d, want):
    from animate_anything_tpu_torch.ops.temporal_attention import MAX_HEAD_DIM, packed_ok

    assert MAX_HEAD_DIM == 256
    assert packed_ok((2, 17, 256, 1, d), "packed", on_cuda=True) == want
    assert not packed_ok((2, 17, 256, 1, d), "packed", on_cuda=False)


def test_vae_and_clip_attention_take_xla_attention():
    """JAX's VAE mid-block and CLIP text encoder call ``attention(...,
    impl="xla")``; so do the port's, counted through ``xla_attention``."""
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig, decode_video
    from animate_anything_tpu_torch.ops import attention as attn

    torch.manual_seed(0)
    vae = AutoencoderKL(VAEConfig.tiny()).eval()
    cfg = CLIPTextConfig.tiny()
    text = CLIPTextModel(cfg).eval()
    with mock.patch.object(attn, "xla_attention", wraps=attn.xla_attention) as xla, \
            mock.patch.object(attn, "flash_attention", wraps=attn.flash_attention) as kernel, \
            torch.no_grad():
        video = decode_video(vae, torch.randn(1, 2, 4, 4, 4))
        calls_vae = xla.call_count
        hidden = text(torch.randint(0, cfg.vocab_size, (2, 16)))
    assert calls_vae == 1                             # the decoder's mid-block
    assert xla.call_count == 1 + cfg.num_layers       # one causal attention a layer
    assert all(c.kwargs.get("is_causal") for c in xla.call_args_list[1:])
    assert kernel.call_count == 0
    assert video.shape == (1, 2, 32, 32, 3) and hidden.shape == (2, 16, cfg.hidden_size)


# ---- kernel 2: LN + GEGLU -----------------------------------------------------

def _geglu_inputs(c, inner, rows, seed):
    r = _rng(seed)
    x = r.standard_normal((rows, c)).astype(np.float32)
    s = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    b = (0.05 * r.standard_normal(c)).astype(np.float32)
    w1 = (0.05 * r.standard_normal((c, 2 * inner))).astype(np.float32)   # JAX (in, out)
    b1 = (0.1 * r.standard_normal(2 * inner)).astype(np.float32)
    w2 = (0.05 * r.standard_normal((inner, c))).astype(np.float32)
    b2 = (0.1 * r.standard_normal(c)).astype(np.float32)
    return x, s, b, w1, b1, w2, b2


def _port_geglu(x, s, b, w1, b1, w2, b2):
    from animate_anything_tpu_torch.ops.geglu import ln_geglu_ff

    # torch Linear layout: w1 (8c, c), w2 (c, 4c)
    return ln_geglu_ff(t(x), t(s), t(b), t(w1.T), t(b1), t(w2.T), t(b2))


def test_ln_geglu_plain_matches_jax_kernel_and_twin():
    from animate_anything_tpu.ops.geglu import _pallas_ln_geglu, _reference

    args = _geglu_inputs(128, 512, 40, 0)
    got = _port_geglu(*args)
    x, s, b, w1, b1, w2, b2 = args
    with pltpu.force_tpu_interpret_mode():
        want_kernel = _pallas_ln_geglu(x, s, b, w1, b1[None], w2, b2[None], 1e-5, rows=16)
    want_twin = _reference(x, s, b, w1, b1, w2, b2, 1e-5, approximate=True)
    np.testing.assert_allclose(n(got), n(want_kernel), atol=3e-5)
    np.testing.assert_allclose(n(got), n(want_twin), atol=3e-5)


def test_ln_geglu_public_entry_matches_jax_perf_path():
    """ln_geglu_ff over (..., c) equals the JAX ``impl="pallas"`` entry on the
    CPU (its lean tanh-GELU composite)."""
    from animate_anything_tpu.ops.geglu import ln_geglu_ff as jax_ff

    x, s, b, w1, b1, w2, b2 = _geglu_inputs(64, 256, 24, 1)
    x3 = x.reshape(2, 12, 64)
    want = jax_ff(x3, s, b, w1, b1, w2, b2, impl="pallas")
    got = _port_geglu(x3, s, b, w1, b1, w2, b2)
    np.testing.assert_allclose(n(got), n(want), atol=3e-5)


@pytest.mark.slow  # interpret-mode wide kernel is compile-heavy, as in tests/test_ops.py
def test_ln_geglu_plain_matches_jax_wide_kernel():
    from animate_anything_tpu.ops.geglu import _fused_wide_p, _pick_rows_wide

    args = _geglu_inputs(256, 1024, 272, 2)
    x, s, b, w1, b1, w2, b2 = args
    with pltpu.force_tpu_interpret_mode():
        want = _fused_wide_p(x, s, b, w1, b1, w2, b2, 1e-5, _pick_rows_wide(256, 272))
    np.testing.assert_allclose(n(_port_geglu(*args)), n(want), atol=3e-5)


# ---- kernel 3: GN-apply + SiLU + tap conv ---------------------------------------

def _tap_inputs(seed, b=2, f=5, s=24, cin=128, cout=128):
    r = _rng(seed)
    x = r.standard_normal((b, f, s, cin)).astype(np.float32)
    a = (1.0 + 0.1 * r.standard_normal((b, cin))).astype(np.float32)
    bv = (0.1 * r.standard_normal((b, cin))).astype(np.float32)
    w = (0.05 * r.standard_normal((3, cin, cout))).astype(np.float32)   # JAX taps (3, in, out)
    bias = (0.1 * r.standard_normal(cout)).astype(np.float32)
    res = r.standard_normal((b, f, s, cout)).astype(np.float32)
    return x, a, bv, w, bias, res


@pytest.mark.parametrize("with_residual", [False, True])
def test_tap_conv_plain_matches_jax_kernel_and_twin(with_residual):
    from animate_anything_tpu.ops.temporal_conv import _pallas_stage, _reference_stage_stats
    from animate_anything_tpu_torch.ops.temporal_conv import tap_conv

    x, a, bv, w, bias, res = _tap_inputs(0)
    res = res if with_residual else None
    y, (s1, s2) = tap_conv(t(x), t(a), t(bv), t(w.transpose(2, 0, 1)), t(bias),
                           None if res is None else t(res))
    with pltpu.force_tpu_interpret_mode():
        ky = _pallas_stage(x, a, bv, w, bias, res, ch=8)
        sy, ks1, ks2 = _pallas_stage(x, a, bv, w, bias, res, ch=8, emit_stats=True)
    ry, rs1, rs2 = _reference_stage_stats(x, a, bv, w, bias, res)
    for want_y in (ky, sy, ry):
        np.testing.assert_allclose(n(y), n(want_y), atol=2e-5)
    for got_s, want_s in ((s1, ks1), (s2, ks2), (s1, rs1), (s2, rs2)):
        np.testing.assert_allclose(n(got_s), n(want_s), rtol=2e-5, atol=1e-3)


def test_gn_silu_tap_conv_matches_jax_with_and_without_sums():
    """The whole stage (GroupNorm fold + kernel) against the JAX entry; the
    sums input path gives the same result as letting the fold reduce x."""
    from animate_anything_tpu.ops.temporal_conv import gn_silu_tap_conv as jax_stage
    from animate_anything_tpu_torch.ops.temporal_conv import gn_silu_tap_conv

    r = _rng(4)
    b, f, s, c = 2, 4, 16, 64
    x = r.standard_normal((b, f, s, c)).astype(np.float32)
    gs = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    gb = (0.1 * r.standard_normal(c)).astype(np.float32)
    w = (0.05 * r.standard_normal((3, c, c))).astype(np.float32)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    want = jax_stage(x, gs, gb, w, bias, groups=8, impl="pallas")
    w_conv3d = t(w.transpose(2, 1, 0)[..., None, None])        # (out, in, 3, 1, 1)
    y0, _ = gn_silu_tap_conv(t(x), t(gs), t(gb), w_conv3d, t(bias), groups=8)
    xf = x.reshape(b, f * s, c)
    sums = (t(xf.sum(1)), t((xf * xf).sum(1)))
    y1, _ = gn_silu_tap_conv(t(x), t(gs), t(gb), w_conv3d, t(bias), groups=8, sums=sums)
    np.testing.assert_allclose(n(y0), n(want), atol=2e-5)
    np.testing.assert_allclose(n(y1), n(want), atol=2e-5)


# ---- kernel 4: proj + residual + stats ------------------------------------------

@pytest.mark.parametrize("k", [64, 96])   # k ≠ c, as at transformer_in (512 → 320)
def test_proj_residual_plain_matches_jax_kernel_and_twin(k):
    from animate_anything_tpu.ops.proj_residual import _pallas_proj, _reference
    from animate_anything_tpu_torch.ops.proj_residual import proj_residual_stats

    r = _rng(k)
    nn_, s, c = 3, 32, 128
    h = r.standard_normal((nn_, s, k)).astype(np.float32)
    w = (0.05 * r.standard_normal((k, c))).astype(np.float32)   # JAX (in, out)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    res = r.standard_normal((nn_, s, c)).astype(np.float32)
    y, (s1, s2) = proj_residual_stats(t(h), t(w.T), t(bias), t(res))
    with pltpu.force_tpu_interpret_mode():
        ky, ks1, ks2 = _pallas_proj(h, w, bias, res, ch=8)
    ry, rs1, rs2 = _reference(h, w, bias, res)
    for want_y, want1, want2 in ((ky, ks1, ks2), (ry, rs1, rs2)):
        np.testing.assert_allclose(n(y), n(want_y), atol=2e-5)
        np.testing.assert_allclose(n(s1), n(want1), rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(n(s2), n(want2), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("s", [100, 64])   # ragged (s % 64 ≠ 0), and one sub-tile a slab
def test_proj_residual_plain_matches_jax_kernel_at_the_slab_edges(s):
    """The kernel pairs 64-row sub-tiles of one slab into a tile: at a ragged
    s the last sub-tile of each slab is cut by the slab, at s = 64 a tile
    holds two slabs. The plain version holds the per-slab sums there, as
    the Pallas kernel and its twin compute them."""
    from animate_anything_tpu.ops.proj_residual import _pallas_proj, _reference
    from animate_anything_tpu_torch.ops.proj_residual import proj_residual_stats

    r = _rng(s)
    nn_, k, c = 3, 64, 128
    h = r.standard_normal((nn_, s, k)).astype(np.float32)
    w = (0.05 * r.standard_normal((k, c))).astype(np.float32)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    res = r.standard_normal((nn_, s, c)).astype(np.float32)
    y, (s1, s2) = proj_residual_stats(t(h), t(w.T), t(bias), t(res))
    with pltpu.force_tpu_interpret_mode():
        ky, ks1, ks2 = _pallas_proj(h, w, bias, res, ch=4 if s % 8 else 8)
    ry, rs1, rs2 = _reference(h, w, bias, res)
    for want_y, want1, want2 in ((ky, ks1, ks2), (ry, rs1, rs2)):
        np.testing.assert_allclose(n(y), n(want_y), atol=2e-5)
        np.testing.assert_allclose(n(s1), n(want1), rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(n(s2), n(want2), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("op", ["tap_conv", "proj_residual"])
def test_plain_stats_are_sums_of_the_stored_bf16_output(op):
    """With bf16 activations the Σy, Σy² epilogue sums the rounded y that is
    returned, which the consumer GroupNorm normalises, and not the fp32 y
    before rounding. Same y, same summation: agreement to fp32 noise (1e-4
    over 512 rows); the unrounded sums differ by ~2e-2, which must show."""
    from animate_anything_tpu_torch.ops.proj_residual import proj_residual_stats
    from animate_anything_tpu_torch.ops.temporal_conv import tap_conv

    if op == "tap_conv":
        x, a, bv, w, bias, res = _tap_inputs(10, b=1, f=3, s=512, cin=32, cout=32)
        args = (x, a, bv, w.transpose(2, 0, 1), bias, res)
        fn, dim = tap_conv, 2
    else:
        r = _rng(11)
        args = (r.standard_normal((2, 512, 32)), 0.2 * r.standard_normal((32, 32)),
                0.1 * r.standard_normal(32), r.standard_normal((2, 512, 32)))
        fn, dim = proj_residual_stats, 1
    # bf16 activations; the fp32 run gets the very same (bf16-representable) values
    args = [t(np.asarray(v, np.float32)).to(torch.bfloat16).float() for v in args]
    bf = [v.to(torch.bfloat16) if v.ndim >= 3 else v for v in args]
    y, (s1, s2) = fn(*bf)
    assert y.dtype == torch.bfloat16
    yf = y.float()
    np.testing.assert_allclose(n(s1), n(yf.sum(dim)), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(n(s2), n(yf.square().sum(dim)), rtol=1e-6, atol=1e-4)
    y32, (u1, _) = fn(*args)
    assert y32.dtype == torch.float32
    assert float((s1 - u1).abs().max()) > 1e-2


# ---- plain ops: group norm, frame attention ---------------------------------------

@pytest.mark.parametrize("silu,use_sums", [(True, False), (False, True)])
def test_group_norm_matches_jax(silu, use_sums):
    from animate_anything_tpu.ops.group_norm import group_norm_silu as jax_gn
    from animate_anything_tpu_torch.ops.group_norm import group_norm_silu

    r = _rng(6)
    x = (2.0 * r.standard_normal((3, 4, 5, 64)) + 0.5).astype(np.float32)
    sc = (1.0 + 0.1 * r.standard_normal(64)).astype(np.float32)
    bi = (0.1 * r.standard_normal(64)).astype(np.float32)
    x2 = x.reshape(3, -1, 64)
    sums = (x2.sum(1), (x2 * x2).sum(1)) if use_sums else None
    want = jax_gn(x, sc, bi, 8, 1e-6, silu=silu, sums=sums)
    got = group_norm_silu(t(x), t(sc), t(bi), 8, 1e-6, silu=silu,
                          sums=None if sums is None else tuple(map(t, sums)))
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)


def test_temporal_attention_matches_jax_einsum():
    from animate_anything_tpu.ops.temporal_attention import _einsum_reference
    from animate_anything_tpu_torch.ops.temporal_attention import temporal_attention

    r = _rng(7)
    q, k, v = (r.standard_normal((2, 17, 12, 3, 16)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(n(temporal_attention(t(q), t(k), t(v))),
                               n(_einsum_reference(q, k, v)), atol=2e-5)


# ---- diffusion math ---------------------------------------------------------------

def test_schedule_tables_and_timesteps_match_jax():
    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu.diffusion.samplers import dpmpp_timesteps as jax_ts
    from animate_anything_tpu_torch.diffusion import dpmpp_timesteps, make_schedule

    for zero_snr in (False, True):
        js, ps = jax_schedule(rescale_betas_zero_snr=zero_snr), \
            make_schedule(rescale_betas_zero_snr=zero_snr)
        np.testing.assert_array_equal(n(ps.alphas_cumprod), np.asarray(js.alphas_cumprod))
        np.testing.assert_array_equal(n(ps.betas), np.asarray(js.betas))
    for steps in (2, 10, 25):
        np.testing.assert_array_equal(dpmpp_timesteps(1000, steps), jax_ts(1000, steps))


def test_forward_mask_noising_matches_jax():
    from animate_anything_tpu.diffusion import ddpm_forward_mask as jax_mask
    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu_torch.diffusion import ddpm_forward_mask, make_schedule

    r = _rng(8)
    x0 = r.standard_normal((1, 1, 8, 8, 4)).astype(np.float32)
    mask = (r.random((1, 1, 8, 8, 1)) > 0.5).astype(np.float32)
    ts = np.array([921, 800])
    key = jax.random.PRNGKey(3)
    want = jax_mask(jax_schedule(), x0, mask, 5, jnp.asarray(ts), key)
    noise = jax.random.normal(key, (1, 5, 8, 8, 4), jnp.float32)   # what JAX drew
    got = ddpm_forward_mask(make_schedule(), t(x0), t(mask), 5, ts, noise=t(noise))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


@pytest.mark.parametrize("steps", [3, 16])   # 1st-order last step below 15 steps only
def test_dpmpp_loop_matches_jax(steps):
    """The Python-loop sampler against the JAX lax.scan one, with a toy model
    whose output depends on x and t."""
    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu.diffusion import sample_loop as jax_loop
    from animate_anything_tpu.diffusion.samplers import dpmpp_timesteps as jax_ts
    from animate_anything_tpu_torch.diffusion import make_schedule, sample_loop

    x = _rng(9).standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
    ts = jax_ts(1000, steps)[1:]
    want = jax_loop(jax_schedule(), jnp.asarray(x), ts,
                    lambda s, tt: 0.3 * s + tt.astype(jnp.float32) / 1000.0)
    got = sample_loop(make_schedule(), t(x), ts, lambda s, tt: 0.3 * s + tt / 1000.0)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
