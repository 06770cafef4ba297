"""The port's flash-attention backward against the JAX package's, on the CPU.

JAX side: ``jax.vjp`` through ``animate_anything_tpu.ops.flash_attention.
flash_attention`` under ``pltpu.force_tpu_interpret_mode()``, so its custom
VJP runs the Pallas dq and dk/dv kernels in interpret mode: the lanes
kernels at d = 64 (``_flash_backward_lanes``), the folded-heads kernels at
d = 16, 32, 96, 128 and 256 (``_flash_backward``). Port side: the plain backward
``flash_attention_backward_reference`` and the autograd Function
``FlashAttention`` (whose CPU backward is that plain version), on the same
numpy inputs, in fp32.

Tolerance 1e-5 absolute on unit-scale inputs and cotangents: the same fp32
products, summed in another order (the Pallas kernels rebuild the softmax
from a row max; the plain version from ``logsumexp``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import n, t

ATOL = 1e-5

CASES = {
    "lanes": (2, 256, 256, 2, 64),
    "ragged-odd-heads": (1, 200, 200, 3, 64),
    "folded-d32": (2, 128, 128, 2, 32),
    "folded-d128": (1, 256, 256, 2, 128),
    "sq-ne-sk": (1, 128, 320, 2, 64),
    # head sizes the backward kernel took on beside 32/64/128
    "folded-d16": (1, 128, 128, 2, 16),
    "folded-d96-sq-ne-sk": (1, 200, 136, 1, 96),
    "folded-d256": (1, 128, 128, 1, 256),
}


def _inputs(b, sq, sk, h, d, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, sq, h, d)).astype(np.float32)
    k = r.standard_normal((b, sk, h, d)).astype(np.float32)
    v = r.standard_normal((b, sk, h, d)).astype(np.float32)
    do = r.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do):
    from animate_anything_tpu.ops.flash_attention import flash_attention

    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(flash_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return o, vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_matches_pallas(case):
    from animate_anything_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(*CASES[case])
    want_o, want = _jax_grads(q, k, v, do)

    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    o = fa.flash_attention(qt, kt, vt)
    np.testing.assert_allclose(n(o), n(want_o), atol=ATOL)
    o.backward(t(do))
    plain = fa.flash_attention_backward_reference(t(q), t(k), t(v), o.detach(), t(do))
    for name, got_fn, got_plain, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), plain, want):
        np.testing.assert_allclose(n(got_fn), n(ref), atol=ATOL, err_msg=f"d{name} (Function)")
        np.testing.assert_allclose(n(got_plain), n(ref), atol=ATOL, err_msg=f"d{name} (plain)")


def test_dispatch_sends_short_and_causal_attention_to_torch_autograd():
    """Below 128 positions and for causal attention the port runs the plain
    attention, differentiated by torch as JAX leaves it to XLA; only the
    flash sites go through the Function."""
    from animate_anything_tpu_torch.ops import attention as dispatch
    from animate_anything_tpu_torch.ops.flash_attention import FlashAttention

    q, k, v, _ = (t(a).requires_grad_(True) for a in _inputs(1, 128, 77, 2, 32))
    name = FlashAttention.__name__
    assert name not in dispatch.attention(q, k, v).grad_fn.name()
    q2, k2, v2, _ = (t(a).requires_grad_(True) for a in _inputs(1, 128, 128, 2, 32))
    assert name in dispatch.attention(q2, k2, v2).grad_fn.name()
    assert name not in dispatch.attention(q2, k2, v2, is_causal=True).grad_fn.name()


def test_backward_reference_rounds_like_the_kernels_in_bf16():
    """In bf16 the plain backward rounds q̂, P and dS before their products,
    as the TPU kernels do: it stays within bf16 storage error of the fp32
    backward on the same (bf16-representable) inputs."""
    from animate_anything_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (t(a).to(torch.bfloat16) for a in _inputs(1, 128, 128, 2, 64, seed=3))
    o = fa.attention_reference(q, k, v)
    got = fa.flash_attention_backward_reference(q, k, v, o, do)
    want = fa.flash_attention_backward_reference(*(a.float() for a in (q, k, v, o, do)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) < 2e-2 * scale
