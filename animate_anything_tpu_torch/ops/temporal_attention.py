"""Attention over the frame axis — the einsum form of
``animate_anything_tpu/ops/temporal_attention.py::_einsum_reference``.

q/k/v are (b, f, s, h, d); each (b, s, h) location attends over its f
frames. fp32 scores and softmax, probabilities cast to v's dtype for the
second product, as in JAX. The JAX package's packed Pallas kernel is reached
only with ``impl="packed"`` and is not on this port's main path.
"""

from __future__ import annotations

import math

import torch


def temporal_attention(q, k, v) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * scale
    probs = scores.softmax(dim=-1).to(v.dtype)
    out = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float())
    return out.to(q.dtype)
