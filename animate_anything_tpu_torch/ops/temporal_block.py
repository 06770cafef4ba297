"""Kernel 5: the fused temporal-attention block (``csrc/temporal_block.cu``).

Replaces both JAX entry points of ``animate_anything_tpu/ops/temporal_block.py``:
``fused_temporal_block_bfsc`` (``_build_bfsc``, the natural (b, f, s, c)
layout) and ``fused_temporal_attn_block`` (``_build`` on the packed token
layout, with the head-group split of ``_build_vjp`` at c = 1280). On real
rows both compute the same function; packing rows into 128-row tiles and
splitting heads to fit VMEM are facts of the TPU, so the port has one entry
point on the natural layout. The design note (locations per block, the
ragged edge) is in the source's header.

Weights arrive in the torch Linear layout (out, in): ``to_q``, ``to_k``,
``to_v`` (no bias) and ``to_out.0`` of a ``TemporalSelfAttention``.

``fused_ok`` is the JAX gate (:579) between this block and the composite
temporal path. It decides the GELU form of the block's feed-forward (tanh on
the fused path, exact erf on the composite one), so the port keeps it as it
is for every shape, not only for the shapes the kernel takes.

Gradients: ``ops/autograd.Recompute`` differentiates ``temporal_block_twin``
(JAX's ``_reference_bfsc``, the custom_vjp's remat target); above
``SPLIT_C`` one Function covers both launches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute

MAX_FRAMES = 32   # two 16-row query tiles per location
MAX_HEAD_DIM = 64
SPLIT_C = 1024    # wider blocks take two launches (see the source's header)

launches = 0  # kernel launches by temporal_block (two per call above SPLIT_C)


def _n_head_groups(c: int, heads: int) -> int:
    """The JAX head-group count (``ops/temporal_block.py:497``), needed only
    by the gate: c ≤ 1024 → 1; c = 1280 (20 heads) → 2."""
    ngroups = 1
    while 4 * c * (c // ngroups) * 2 > 8 * 2**20:
        ngroups += 1
    while heads % ngroups:
        ngroups += 1
    return ngroups


def fused_ok(f: int, c: int, heads: int, head_dim: int) -> bool:
    """The JAX geometry gate of the fused temporal path (``:579``)."""
    if not (2 <= f <= 128 and heads * head_dim == c and head_dim % 8 == 0):
        return False
    if c <= 1024:
        return True
    return c <= 2048 and heads % _n_head_groups(c, heads) == 0


def temporal_block_reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """Plain version on (b, f, s, c), the arithmetic of JAX's
    ``_reference_bfsc``: LN in fp32 stored in x's dtype; each projection
    with fp32 accumulation rounded to x's dtype; fp32 scores × 1/√d and
    softmax over the f frames; probabilities in v's dtype; the attention
    output rounded to x's dtype; out-projection in fp32 plus bo and x."""
    b, f, s, c = x.shape
    d = c // heads
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)

    def proj(w):
        return (ln.float() @ w.float().t()).to(dt).reshape(b, f, s, heads, d)

    q, k, v = proj(wq), proj(wk), proj(wv)
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * (1.0 / math.sqrt(d))
    probs = scores.softmax(dim=-1).to(v.dtype)
    o = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float()).to(dt)
    out = o.reshape(b, f, s, c).float() @ wo.float().t() + bo.float() + xf
    return out.to(dt)


def temporal_block_twin(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int,
                        eps: float) -> torch.Tensor:
    """Differentiable twin of JAX's ``_reference_bfsc`` in x's dtype: the
    four projections on x-dtype operands with fp32 accumulation, the
    17-frame attention in fp32 as in ``temporal_block_reference`` (which it
    is, in fp32)."""
    b, f, s, c = x.shape
    d = c // heads
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)
    q, k, v = (F.linear(ln, w).reshape(b, f, s, heads, d) for w in (wq, wk, wv))
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * (1.0 / math.sqrt(d))
    probs = scores.softmax(dim=-1).to(dt)
    o = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float()).to(dt)
    out = F.linear(o.reshape(b, f, s, c), wo).float() + bo.float() + xf
    return out.to(dt)


def _launch(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int, eps: float) -> torch.Tensor:
    b, f, s, c = x.shape
    if heads < 1 or c % heads:
        raise ValueError(f"temporal_block: {heads} heads do not divide c={c}")
    d = c // heads
    if not (1 <= f <= MAX_FRAMES and c % 32 == 0 and d % 16 == 0 and d <= MAX_HEAD_DIM):
        raise ValueError(f"temporal_block: needs f ≤ {MAX_FRAMES}, c % 32 == 0 and head dim "
                         f"a multiple of 16 ≤ {MAX_HEAD_DIM}; got f={f} c={c} d={d}")
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("temporal_block x", x, bf, (b, f, s, c))
    for name, t in (("ln scale", ln_scale), ("ln bias", ln_bias), ("bo", bo)):
        cuda_lib.check_cuda(f"temporal_block {name}", t, f32, (c,))
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        cuda_lib.check_cuda(f"temporal_block {name}", w, bf, (c, c))
    global launches
    y = torch.empty_like(x)
    # above SPLIT_C the kernel leaves the attention output in o, and the
    # out-projection + bo + x is kernel 4's GEMM without its sums
    o = torch.empty_like(x) if c > SPLIT_C else y
    cuda_lib.call("aat_temporal_block", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                  wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                  o.data_ptr(), y.data_ptr(), b, f, s, c, heads, eps, 1.0 / math.sqrt(d))
    launches += 1
    if c > SPLIT_C:
        cuda_lib.call("aat_proj_residual", o.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                      x.data_ptr(), y.data_ptr(), None, None, b * f, s, c, c)
        launches += 1
    return y


def temporal_block(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads: int,
                   eps: float = 1e-5) -> torch.Tensor:
    """``x + bo + Wo·attn(LN(x))`` on x (b, f, s, c), attention over the f
    frames of each (b, s, head)."""
    dt = x.dtype
    args = (x, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            wq.to(dt).contiguous(), wk.to(dt).contiguous(), wv.to(dt).contiguous(),
            wo.to(dt).contiguous(), bo.float().contiguous())
    run = _reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, temporal_block_twin, *args, heads, eps)


def _reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int, eps: float):
    return temporal_block_reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads=heads,
                                    eps=eps)
