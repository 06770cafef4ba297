"""Kernel 1: flash attention forward (``csrc/flash_attention.cu``).

Replaces ``animate_anything_tpu/ops/flash_attention.py::_flash_forward_lanes``
(d = 64) and ``::_flash_forward`` (other head sizes). The CUDA kernel takes d
in {32, 64, 128} and reads q/k/v straight from the ``(b, s, h·d)`` projection
outputs, one head per block column, by stride. What bounds it on the H100
and how its design answers that is in the source's header note.

``flash_attention`` is the wrapper: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the kernel (or an error). The dispatch between this
kernel and plain attention lives in ``ops/attention.py``.
"""

from __future__ import annotations

import math

import torch

from animate_anything_tpu_torch.ops import cuda_lib

LOG2E = 1.4426950408889634
HEAD_DIMS = (32, 64, 128)

launches = 0  # kernel launches by flash_attention (reset by callers that count)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q (B, Sq, H, D), k/v (B, Sk, H, D) → (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    cuda_lib.check_cuda("flash_attention q", q, torch.bfloat16, (b, sq, h, d))
    cuda_lib.check_cuda("flash_attention k", k, torch.bfloat16, (b, sk, h, d))
    cuda_lib.check_cuda("flash_attention v", v, torch.bfloat16, (b, sk, h, d))
    out = torch.empty_like(q)
    cuda_lib.call("aat_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, sq, sk, h, d, LOG2E / math.sqrt(d))
    global launches
    launches += 1
    return out
