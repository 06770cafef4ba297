"""Latent-space motion metrics — the port of the differentiable part of
``animate_anything_tpu/metrics/motion.py``.

- ``latent_motion_score``: 10·Σ_c mean|Δ_t latents|, the motion strength the
  trainer conditions on and its auxiliary loss compares;
- ``motion_mask_loss``: frame-difference magnitude outside the mask.

Both take (b, f, h, w, c) tensors and stay differentiable. The pixel-space
metrics (moved-area masks, HSV motion score, PSNR) are not ported yet.
"""

from __future__ import annotations

import torch


def latent_motion_score(latents: torch.Tensor) -> torch.Tensor:
    """latents (b, f, h, w, c) → (b,): 10 · Σ_c mean over (f−1, h, w) of |Δ_t|."""
    diff = (latents[:, 1:] - latents[:, :-1]).abs()
    return diff.mean(dim=(1, 2, 3)).sum(-1) * 10.0


def motion_mask_loss(latents: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Motion outside the mask (mask broadcastable, 1 = may move) → (b,)."""
    diff = (latents[:, 1:] - latents[:, :-1]).abs()
    return (diff * (1.0 - mask)).mean(dim=(1, 2, 3)).sum(-1)
