"""Attention dispatch — the port of ``animate_anything_tpu/ops/attention.py``
together with the routing of ``ops/flash_attention.py::flash_attention``.

All inputs are (batch, seq, heads, head_dim). Any site with fewer than 128
query or key positions (cross-attention over the 77 text tokens, the 8×8 mid
block) runs plain attention, as the JAX package leaves it to XLA; everything
else runs kernel 1. Causal attention (the CLIP text encoder's, which JAX
sends to XLA with ``impl="xla"``) always runs plain.
"""

from __future__ import annotations

import torch

from animate_anything_tpu_torch.ops.flash_attention import attention_reference, flash_attention

MIN_KERNEL_SEQ = 128


def attention(q, k, v, is_causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H, D) tensors."""
    if is_causal or q.shape[1] < MIN_KERNEL_SEQ or k.shape[1] < MIN_KERNEL_SEQ:
        return attention_reference(q, k, v, is_causal=is_causal)
    return flash_attention(q, k, v)
