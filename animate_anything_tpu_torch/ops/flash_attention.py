"""Kernel 1: flash attention, forward (``csrc/flash_attention.cu``) and
backward (``csrc/flash_attention_bwd.cu``).

The forward replaces ``animate_anything_tpu/ops/flash_attention.py::
_flash_forward_lanes`` (d = 64) and ``::_flash_forward`` (other head sizes);
the backward replaces ``::_flash_backward_lanes`` and ``::_flash_backward``
(the dq and dk/dv Pallas kernels). ``flash_attention`` also stands for
``animate_anything_tpu/ops/attic/packed_flash.py::_flash_forward_packed``,
the same function on the same layout (it takes ``exp`` of the scores where
kernel 1 takes ``exp2`` of the scores × log2 e, in fp32 both), whose custom
VJP differentiates plain attention as this backward does. The forward
and backward kernels (TMA and wgmma) take every d % 16 == 0 from 16 to 256
(``HEAD_DIMS``, ``BWD_HEAD_DIMS``); both read q/k/v (and o, dO) straight
from the ``(b, s, h·d)`` projection outputs, one head per block column, by
stride. What bounds them on the H100 and how
their design answers that is in the sources' header notes.

``flash_attention`` is the wrapper: ``FlashAttention`` (an autograd
Function) runs the plain PyTorch versions for CPU tensors and the kernels
for CUDA tensors (or raises). When autograd needs it, the forward kernel
also stores each row's log-sum-exp for the backward. The dispatch between
this kernel and plain attention lives in ``ops/attention.py``; ``kernel_ok``
says which head sizes it may send here.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.utils.tracing import traced

HEAD_DIMS = tuple(range(16, 257, 16))   # the forward kernel's
BWD_HEAD_DIMS = HEAD_DIMS                # the backward kernels'
LOG2E = 1.4426950408889634

launches = 0      # forward kernel launches
bwd_launches = 0  # backward launches (each one dq and one dk/dv kernel)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        is_causal: bool = False) -> torch.Tensor:
    """Plain version: softmax(q·kᵀ/√d)·v over (B, S, H, D) in fp32, cast back
    to q's dtype. ``is_causal``: query i attends keys ≤ i."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        keep = torch.ones(scores.shape[-2:], dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v.float())
    return out.to(q.dtype)


def flash_attention_backward_reference(q, k, v, o, do):
    """Plain backward with the JAX kernels' arithmetic (``_bwd_dq_kernel``,
    ``_bwd_dkv_kernel``): q pre-scaled by 1/√d and rounded to q's dtype
    before q̂·kᵀ; p = exp(s − lse); Δ = rowsum(dO ⊙ O) in fp32; ds = p ⊙ (dp −
    Δ), rounded before dq = ds·k/√d and dk = dsᵀ·q̂; p rounded before dv =
    pᵀ·dO. All (B, S, H, D); returns (dq, dk, dv) in the input dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    qh = (q.float() * scale).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), k.float())
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qh.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_ok(q_shape, k_shape) -> bool:
    """Whether the kernels take attention of q (B, Sq, H, D) over k (B, Sk, H,
    D), with or without a gradient: the backward takes every head size the
    forward does. (TMA's rule that a row of h·d bf16 values be a multiple of
    16 bytes holds for every d % 16 == 0.)"""
    d = q_shape[-1]
    return d == k_shape[-1] and d in HEAD_DIMS


def _check(q, k, v, head_dims=HEAD_DIMS):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in head_dims:
        raise ValueError(f"flash_attention: head dim {d} not in {head_dims}")
    cuda_lib.check_cuda("flash_attention q", q, torch.bfloat16, (b, sq, h, d))
    cuda_lib.check_cuda("flash_attention k", k, torch.bfloat16, (b, sk, h, d))
    cuda_lib.check_cuda("flash_attention v", v, torch.bfloat16, (b, sk, h, d))
    return b, sq, sk, h, d


@traced("op.flash_forward_with_lse")
def flash_forward_with_lse(q, k, v, with_lse: bool = True, prescaled: bool = False):
    """Kernel 1 on CUDA tensors, returning ``(o, lse)``: with ``with_lse``
    it also stores each row's log-sum-exp (fp32 (b, h, sq), log2 domain of
    the pre-scaled scores), the residual the backward kernels take.
    ``prescaled``: q already holds q·log2 e/√d rounded to bf16 (the TPU
    forward kernels' pre-scale), so the kernel neither scales q nor the
    scores."""
    b, sq, sk, h, d = _check(q, k, v)
    scale, exp2_scale = (1.0, 1.0) if prescaled else (1.0 / math.sqrt(d), LOG2E)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), device=q.device, dtype=torch.float32) if with_lse
           else None)
    cuda_lib.call("aat_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(), b, sq, sk, h, d,
                  scale, exp2_scale)
    global launches
    launches += 1
    return out, lse


@traced("op.flash_attention_backward")
def flash_attention_backward(q, k, v, o, do, lse=None):
    """(dq, dk, dv) of non-causal attention for the cotangent ``do``: the
    plain version for CPU tensors, the dq and dk/dv kernels for CUDA tensors
    (``lse`` from ``flash_forward_with_lse`` is required there)."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do)
    b, sq, sk, h, d = _check(q, k, v, BWD_HEAD_DIMS)
    if lse is None:
        raise ValueError("flash_attention_backward: the kernels need the forward's lse")
    cuda_lib.check_cuda("flash_attention o", o, torch.bfloat16, (b, sq, h, d))
    cuda_lib.check_cuda("flash_attention dO", do, torch.bfloat16, (b, sq, h, d))
    cuda_lib.check_cuda("flash_attention lse", lse, torch.float32, (b, h, sq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # lse2 and Δ = rowsum(dO ⊙ O) of each row, padded to 64 rows, and q/√d
    # rounded to bf16: from the dq kernel to the dk/dv kernel
    rows = torch.empty((b, h, 2, -(-sq // 64) * 64), device=q.device, dtype=torch.float32)
    qhat = torch.empty_like(q)
    cuda_lib.call("aat_flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), do.data_ptr(), lse.data_ptr(), rows.data_ptr(), qhat.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d,
                  1.0 / math.sqrt(d))
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Non-causal attention with the kernels' backward: the forward saves
    q, k, v, o (and, on the card, the row log-sum-exp), as JAX's
    ``_flash_attention_p`` saves its residuals."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = attention_reference(q, k, v), None
        else:
            o, lse = flash_forward_with_lse(q, k, v, with_lse=any(ctx.needs_input_grad))
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, do.to(q.dtype).contiguous(), lse)


@traced("op.flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q (B, Sq, H, D), k/v (B, Sk, H, D) → (B, Sq, H, D)."""
    return FlashAttention.apply(q, k, v)
