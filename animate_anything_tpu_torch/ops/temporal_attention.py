"""Attention over the frame axis — the port of
``animate_anything_tpu/ops/temporal_attention.py``, with kernel 9
(``csrc/temporal_attention.cu``) in place of its packed Pallas kernel
(``_packed_forward``).

q/k/v are (b, f, s, h, d); each (b, s, h) location attends over its f
frames: fp32 scores and softmax, probabilities rounded to v's dtype before
the second product, output in q's dtype.

``temporal_attention(..., impl)`` keeps JAX's gate: only ``impl="packed"``
with 2 ≤ f ≤ 128, d % 8 == 0 and at least 512 locations·heads reaches the
kernel, and only on the device the kernel was written for (the TPU there, a
CUDA tensor here). One clause is the port's own: d ≤ 128, the kernel's
largest head; above it JAX runs its packed kernel and the port the einsum
form, the same function. Every other case runs the einsum form
``temporal_attention_reference``, which is also the kernel's plain version
and, through ``ops/autograd.Recompute``, its backward, as JAX's custom VJP
takes the vjp of ``_einsum_reference``.
"""

from __future__ import annotations

import math

import torch

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute

MAX_FRAMES = 128   # JAX's _LANE: the most frames one packed tile holds
MIN_LOCS = 512     # below this many b·s·h locations JAX keeps the einsum form
MAX_HEAD_DIM = 128  # the kernel's; JAX's gate admits any d % 8 == 0

launches = 0  # kernel launches by packed_temporal_attention


def temporal_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version: JAX's ``_einsum_reference``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * scale
    probs = scores.softmax(dim=-1).to(v.dtype)
    out = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float())
    return out.to(q.dtype)


def packed_ok(shape, impl: str, on_cuda: bool) -> bool:
    """JAX's gate (``temporal_attention`` :160-170), with "the tensor is on
    CUDA" for its platform check, and d ≤ ``MAX_HEAD_DIM``."""
    b, f, s, h, d = shape
    return (impl == "packed" and 2 <= f <= MAX_FRAMES and d % 8 == 0 and d <= MAX_HEAD_DIM
            and b * s * h >= MIN_LOCS and on_cuda)


def _launch(q, k, v) -> torch.Tensor:
    b, f, s, h, d = q.shape
    if not 2 <= f <= MAX_FRAMES or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"temporal_attention: f={f} must be in [2, {MAX_FRAMES}] and "
                         f"d={d} a multiple of 8 up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda(f"temporal_attention {name}", t, torch.bfloat16, (b, f, s, h, d))
    o = torch.empty_like(q)
    cuda_lib.call("aat_temporal_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, f, s, h, d)
    global launches
    launches += 1
    return o


def packed_temporal_attention(q, k, v) -> torch.Tensor:
    """Kernel 9 for CUDA tensors, its plain version for CPU tensors; the
    gradient is that of ``temporal_attention_reference``."""
    run = temporal_attention_reference if q.device.type == "cpu" else _launch
    return Recompute.apply(run, temporal_attention_reference, q, k, v)


def temporal_attention(q, k, v, impl: str = "xla") -> torch.Tensor:
    """Attention over axis 1 (frames) of (b, f, s, h, d) tensors."""
    if packed_ok(q.shape, impl, q.device.type == "cuda"):
        return packed_temporal_attention(q, k, v)
    return temporal_attention_reference(q, k, v)
