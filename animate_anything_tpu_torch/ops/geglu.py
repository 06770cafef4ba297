"""Kernel 2: fused LayerNorm → GEGLU feed-forward → residual
(``csrc/geglu.cu``).

Replaces ``animate_anything_tpu/ops/geglu.py::_pallas_ln_geglu`` (c ≤ 640)
and ``::_pallas_ln_geglu_wide`` (c = 1280) with one Hopper kernel for every
width. GELU is the tanh form, the JAX package's default (``_GELU_IMPL``).
The design note (row tiles, register accumulator, hidden streamed 64
columns at a time) is in the source's header.

Weights arrive in the torch Linear layout: ``w1`` (8c, c) with the val rows
first and the gate rows second (diffusers ``GEGLU.proj``), ``w2`` (c, 4c).

Gradients: ``ops/autograd.Recompute`` saves the inputs and differentiates
``ln_geglu_twin``, the torch twin of JAX's ``_reference_lean`` (the
custom_vjp's remat target), as JAX has no backward kernel here either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute

MAX_C = 1280

launches = 0  # kernel launches by ln_geglu_ff


def ln_geglu_reference(x2, s, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Plain version on (n, c) rows, the arithmetic of the kernel: LN in fp32
    stored in x's dtype, both products with fp32 accumulation, the GEGLU
    product rounded to x's dtype before the down-projection."""
    xf = x2.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()).to(x2.dtype)
    h = ln.float() @ w1.float().t() + b1.float()
    val, gate = h.chunk(2, dim=-1)
    act = (val * F.gelu(gate, approximate="tanh")).to(x2.dtype)
    y = act.float() @ w2.float().t() + b2.float() + xf
    return y.to(x2.dtype)


def ln_geglu_twin(x2, s, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Differentiable twin of JAX's ``_reference_lean`` in x2's dtype: LN in
    fp32 stored in x's dtype; both products on x-dtype operands with fp32
    accumulation; the (n, 8c) hidden h stored in x's dtype; tanh GELU in
    fp32. In fp32 it is ``ln_geglu_reference``."""
    dt = x2.dtype
    xf = x2.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()).to(dt)
    h = F.linear(ln, w1, b1.to(dt))
    val, gate = h.chunk(2, dim=-1)
    act = (val.float() * F.gelu(gate.float(), approximate="tanh")).to(dt)
    y = F.linear(act, w2).float() + b2.float() + xf
    return y.to(dt)


def _launch(x2, s, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    n, c = x2.shape
    if c % 16 or c > MAX_C:
        raise ValueError(f"ln_geglu_ff: c={c} must be a multiple of 16 and ≤ {MAX_C}")
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("ln_geglu x", x2, bf, (n, c))
    cuda_lib.check_cuda("ln_geglu ln scale", s, f32, (c,))
    cuda_lib.check_cuda("ln_geglu ln bias", b, f32, (c,))
    cuda_lib.check_cuda("ln_geglu w1", w1, bf, (8 * c, c))
    cuda_lib.check_cuda("ln_geglu b1", b1, f32, (8 * c,))
    cuda_lib.check_cuda("ln_geglu w2", w2, bf, (c, 4 * c))
    cuda_lib.check_cuda("ln_geglu b2", b2, f32, (c,))
    y = torch.empty_like(x2)
    cuda_lib.call("aat_ln_geglu", x2.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(),
                  b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), n, c, eps)
    global launches
    launches += 1
    return y


def ln_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5) -> torch.Tensor:
    """``x + GEGLU_FF(LayerNorm(x))`` over the last axis of x (..., c)."""
    shape = x.shape
    c = shape[-1]
    x2 = x.reshape(-1, c)
    dt = x.dtype
    args = (x2, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            w1.to(dt).contiguous(), b1.float().contiguous(), w2.to(dt).contiguous(),
            b2.float().contiguous())
    run = ln_geglu_reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, ln_geglu_twin, *args, eps).reshape(shape)
