"""Attention dispatch — the port of ``animate_anything_tpu/ops/attention.py``
together with the routing of ``ops/flash_attention.py::flash_attention``.

All inputs are (batch, seq, heads, head_dim). The implementation is chosen
by name, as in JAX:

- ``"pallas"``: any site with fewer than 128 query or key positions
  (cross-attention over the 77 text tokens, the 8×8 mid block) runs plain
  attention, as the JAX package leaves it to XLA; everything else runs
  kernel 1. Causal attention always runs plain (the CLIP text encoder asks
  for ``"xla"``, as JAX's does). On the card, head sizes kernel 1 does not
  take (``flash_attention.kernel_ok``: d % 16 == 8 such as 40, or d > 256;
  forward and backward take the same head sizes) run ``xla_attention``
  instead. That diverges from JAX, whose Pallas kernel
  ``_flash_forward`` takes any d: the numbers are the same softmax, the
  kernel is not.
- ``"xla"`` and ``"packed"`` (any name but ``"pallas"``): JAX's
  ``_xla_attention``, i.e. ``jax.nn.dot_product_attention``. No Pallas
  kernel computes it, since JAX hands it to XLA, so this is not a port of a
  Pallas kernel: on the card it is ``F.scaled_dot_product_attention``, on
  the CPU the plain ``attention_reference``. A plain materialised softmax
  is no option on the card: at s = 4096 over 34 × 5 heads its fp32 scores
  alone would take ~11 GB.

The default implementation is ``"pallas"``, where JAX's is ``"xla"``: every
caller of the port (the pipeline, the trainer, ``UNet3DConfig``) means the
JAX package's ``attn_impl="pallas"`` configuration. The models pass the
configuration's ``attn_impl`` to every call; the port has no process-wide
default to set (JAX's ``set_default_attn_impl`` is called nowhere, its
server's included).

Prompt-to-prompt control (``utils/ptp.py``): while a controller is active,
every non-causal call runs JAX's ``_controlled_attention``: fp32
probabilities materialised, handed to the controller with the call's tag
``(module path, is_cross)`` and its place in the UNet, and what it returns
multiplies v. JAX sends no Pallas kernel down that branch, so plain torch
is the port here. A controller reaches only the calls of the thread that
opened it (``utils/ptp.attention_control``), never a server's worker. The frame attention (``ops/temporal_attention.py``) and
the fused temporal block never call this function, in JAX or here, so the
controller never sees them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops.flash_attention import (attention_reference, flash_attention,
                                                            kernel_ok)
from animate_anything_tpu_torch.utils.ptp import active_controller, place_in_unet

MIN_KERNEL_SEQ = 128


def xla_attention(q, k, v, is_causal: bool = False) -> torch.Tensor:
    """JAX's ``_xla_attention``: SDPA for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, is_causal=is_causal)
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), is_causal=is_causal)
    return out.transpose(1, 2)


def attention(q, k, v, impl: str = "pallas", is_causal: bool = False,
              tag: Optional[tuple] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H, D) tensors. ``tag`` =
    (module path, is_cross) for a prompt-to-prompt controller."""
    ctrl = active_controller()
    if ctrl is not None and not is_causal:
        return _controlled_attention(q, k, v, ctrl, tag)
    if impl != "pallas":
        return xla_attention(q, k, v, is_causal=is_causal)
    if is_causal or q.shape[1] < MIN_KERNEL_SEQ or k.shape[1] < MIN_KERNEL_SEQ:
        return attention_reference(q, k, v, is_causal=is_causal)
    if q.device.type == "cuda" and not kernel_ok(q.shape, k.shape):
        return xla_attention(q, k, v)
    return flash_attention(q, k, v)


def _controlled_attention(q, k, v, ctrl, tag) -> torch.Tensor:
    """JAX's ``_controlled_attention``: fp32 scores and softmax, the
    (b·h, sq, sk) probabilities through the controller, then P·v with fp32
    accumulation, in q's dtype. Untagged calls count as cross-attention
    where q and k are different tensors, as JAX's ``q is not k``."""
    path, is_cross = tag if tag is not None else ((), q is not k)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    probs = torch.softmax(scores, dim=-1).reshape(b * h, sq, sk)
    probs = ctrl(probs, bool(is_cross), place_in_unet(tuple(path))).reshape(b, h, sq, sk)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
