"""The port's counterparts of the JAX package's last three Pallas kernels,
which no model path reaches: the all-heads flash attention
(``ops/attic/packed_flash.py``, kernel 1's function on kernel 1's layout, so
the port's ``flash_attention`` serves it), the residual add with its sums
(``ops/attic/add_stats.py``) and LayerNorm → q/k/v → attention
(``ops/attic/ln_qkv_attention.py``), on the CPU, in fp32.

Each wrapper runs its plain version on CPU tensors; it is held against the
Pallas kernel in interpret mode at the shapes of the JAX package's own tests
(``tests/test_attic_ops.py``), with their tolerances. Gradients go through
``ops/autograd.Recompute``; each is held against ``jax.grad`` of the twin
that JAX's custom VJP differentiates, kernel 9's too (the einsum form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import n, t

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_attic_ops.py's gradient tolerance


def _normal(seed, *shapes, scale=1.0):
    r = np.random.default_rng(seed)
    return [(scale * r.standard_normal(s)).astype(np.float32) for s in shapes]


def _torch_grads(fn, arrays, cotangent):
    """Gradients of Σ fn(*arrays)·cotangent with respect to every array."""
    xs = [t(a).requires_grad_(True) for a in arrays]
    out = fn(*xs)
    (out * t(cotangent)).sum().backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("b,sq,sk,h", [(2, 256, 256, 5), (1, 300, 77, 2)])
def test_flash_attention_packed_matches_pallas(b, sq, sk, h):
    from animate_anything_tpu.ops.attic.packed_flash import _flash_forward_packed
    from animate_anything_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = _normal(h, (b, sq, h, 64), (b, sk, h, 64), (b, sk, h, 64))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_flash_forward_packed(q, k, v))
    with torch.no_grad():
        got = flash_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), want, atol=2e-5)


def test_flash_attention_packed_grad_matches_jax():
    """JAX's VJP is ``_bwd_xla``: the vjp of ``_xla_reference``."""
    from animate_anything_tpu.ops.flash_attention import _xla_reference
    from animate_anything_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, g = _normal(7, (1, 300, 2, 64), (1, 77, 2, 64), (1, 77, 2, 64), (1, 300, 2, 64))
    _, vjp = jax.vjp(_xla_reference, q, k, v)
    want = vjp(jnp.asarray(g))
    got = _torch_grads(flash_attention, (q, k, v), g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_add_with_stats_matches_pallas():
    from animate_anything_tpu.ops.attic.add_stats import _pallas_add
    from animate_anything_tpu_torch.ops.add_stats import add_with_stats

    x, r = _normal(0, (3, 32, 128), (3, 32, 128))
    with pltpu.force_tpu_interpret_mode():
        want_y, want_s1, want_s2 = _pallas_add(x, r, ch=8)
    with torch.no_grad():
        y, (s1, s2) = add_with_stats(t(x), t(r), impl="pallas")
    np.testing.assert_allclose(n(y), np.asarray(want_y), atol=1e-6)
    np.testing.assert_allclose(n(s1), np.asarray(want_s1), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(n(s2), np.asarray(want_s2), rtol=1e-5, atol=1e-3)


def test_add_with_stats_grad_matches_jax():
    """JAX's VJP (``_add_bwd``) is the vjp of ``_reference``; the loss weighs
    all three outputs."""
    from animate_anything_tpu.ops.attic.add_stats import _reference
    from animate_anything_tpu_torch.ops.add_stats import add_with_stats

    x, r = _normal(1, (2, 16, 64), (2, 16, 64))

    def loss_jax(x, r):
        y, s1, s2 = _reference(x, r)
        return (y ** 2).sum() + 0.1 * s1.sum() + 0.01 * s2.sum()

    want = jax.grad(loss_jax, argnums=(0, 1))(x, r)
    xs = [t(a).requires_grad_(True) for a in (x, r)]
    y, (s1, s2) = add_with_stats(*xs, impl="pallas")
    ((y ** 2).sum() + 0.1 * s1.sum() + 0.01 * s2.sum()).backward()
    for a, w in zip(xs, want):
        np.testing.assert_allclose(n(a.grad), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", [None, "xla"])
def test_add_with_stats_has_no_sums_off_pallas(impl):
    from animate_anything_tpu_torch.ops.add_stats import add_with_stats

    x, r = _normal(2, (2, 8, 16), (2, 8, 16))
    y, sums = add_with_stats(t(x), t(r), impl=impl)
    assert sums is None
    np.testing.assert_allclose(n(y), x + r, atol=1e-6)


def _ln_qkv_inputs(b, s, c, heads, seed):
    d = 64
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    x = jax.random.normal(ks[0], (b, s, c))
    lns = 1.0 + 0.1 * jax.random.normal(ks[1], (c,))
    lnb = 0.1 * jax.random.normal(ks[2], (c,))
    ws = [jax.random.normal(kk, (c, heads * d)) * 0.05 for kk in ks[3:]]
    return [np.asarray(a) for a in (x, lns, lnb, *ws)], d


@pytest.mark.parametrize("b,s,c,heads", [(2, 256, 128, 2), (1, 300, 192, 3)])
def test_ln_qkv_attention_matches_pallas(b, s, c, heads):
    from animate_anything_tpu.ops.attic.ln_qkv_attention import _pallas_fwd
    from animate_anything_tpu_torch.ops.ln_qkv_attention import ln_qkv_attention

    arrays, d = _ln_qkv_inputs(b, s, c, heads, heads)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_fwd(*arrays, heads, d, 1e-5))
    with torch.no_grad():
        got = ln_qkv_attention(*map(t, arrays), heads=heads, head_dim=d, impl="pallas")
    assert got.shape == want.shape == (b, s, heads * d)
    np.testing.assert_allclose(n(got), want, atol=3e-5)


def test_ln_qkv_attention_grad_matches_jax():
    """JAX's VJP (``_fused_bwd``) is the vjp of ``_reference``."""
    from animate_anything_tpu.ops.attic.ln_qkv_attention import _reference
    from animate_anything_tpu_torch.ops.ln_qkv_attention import ln_qkv_attention

    arrays, d = _ln_qkv_inputs(1, 256, 128, 2, 0)
    g = _normal(3, (1, 256, 128))[0]
    _, vjp = jax.vjp(lambda *a: _reference(*a, heads=2, d=d, eps=1e-5), *arrays)
    want = vjp(jnp.asarray(g))
    got = _torch_grads(lambda *a: ln_qkv_attention(*a, heads=2, head_dim=d, impl="pallas"),
                       arrays, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("s,head_dim,ok", [(256, 64, True), (4096, 64, True), (255, 64, False),
                                           (256, 32, False)])
def test_ln_qkv_attention_gate(s, head_dim, ok):
    """JAX's domain clauses (head_dim 64, s ≥ 256); its VMEM clause is TPU
    arithmetic and is dropped."""
    from animate_anything_tpu.ops.attic.ln_qkv_attention import ln_qkv_attention_ok as jax_ok
    from animate_anything_tpu_torch.ops.ln_qkv_attention import ln_qkv_attention_ok

    assert ln_qkv_attention_ok(s, head_dim) == ok
    if s <= 2048:   # where JAX's VMEM budget admits a 128-wide sample
        assert jax_ok(s, 128, head_dim) == ok


def test_temporal_attention_grad_matches_jax():
    """Kernel 9's gradient: JAX's custom VJP takes the vjp of
    ``_einsum_reference``."""
    from animate_anything_tpu.ops.temporal_attention import _einsum_reference
    from animate_anything_tpu_torch.ops.temporal_attention import packed_temporal_attention

    q, k, v, g = _normal(4, *[(1, 17, 33, 2, 32)] * 4)
    _, vjp = jax.vjp(_einsum_reference, q, k, v)
    want = vjp(jnp.asarray(g))
    got = _torch_grads(packed_temporal_attention, (q, k, v), g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(w), rtol=1e-4, atol=1e-5)
