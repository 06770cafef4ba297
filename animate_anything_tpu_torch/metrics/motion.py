"""Motion metrics — the port of ``animate_anything_tpu/metrics/motion.py``
without its HSV motion score and PSNR.

- ``latent_motion_score``: 10·Σ_c mean|Δ_t latents|, the motion strength the
  trainer conditions on and its auxiliary loss compares;
- ``motion_mask_loss``: frame-difference magnitude outside the mask;
- ``get_moved_area_mask``: frame differencing, dilation and the bounding
  boxes of the connected moved regions (scipy.ndimage), JAX's numpy path
  (its ``native/motionkit.cpp`` twin comes with the data pipeline);
- ``calculate_motion_precision``: the share of moved pixels inside the
  requested mask, which the eval entry point reports.

The first two take (b, f, h, w, c) tensors and stay differentiable; the
pixel metrics take uint8 frames on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


def latent_motion_score(latents: torch.Tensor) -> torch.Tensor:
    """latents (b, f, h, w, c) → (b,): 10 · Σ_c mean over (f−1, h, w) of |Δ_t|."""
    diff = (latents[:, 1:] - latents[:, :-1]).abs()
    return diff.mean(dim=(1, 2, 3)).sum(-1) * 10.0


def motion_mask_loss(latents: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Motion outside the mask (mask broadcastable, 1 = may move) → (b,)."""
    diff = (latents[:, 1:] - latents[:, :-1]).abs()
    return (diff * (1.0 - mask)).mean(dim=(1, 2, 3)).sum(-1)


def _dilate(binary: np.ndarray, iterations: int, size: int = 3) -> np.ndarray:
    struct = np.ones((size, size), bool)
    return ndimage.binary_dilation(binary, structure=struct, iterations=iterations)


def get_moved_area_mask(frames: np.ndarray, move_th: float = 5.0,
                        th: float = -1.0) -> np.ndarray:
    """frames (f, h, w, 3) uint8 → (h, w) uint8 {0, 255} mask of moved boxes:
    |Δ| of the gray frames against the first and the previous frame above
    ``move_th``, accumulated, dilated twice, then the bounding box of every
    connected component whose area exceeds ``th`` painted."""
    gray = frames.astype(np.int32).mean(axis=-1)
    ref = gray[0]
    acc = np.zeros_like(ref, dtype=bool)
    prev = ref
    for cur in gray[1:]:
        acc |= (np.abs(cur - ref) > move_th) | (np.abs(cur - prev) > move_th)
        prev = cur
    labels, _ = ndimage.label(_dilate(acc, iterations=2))
    mask = np.zeros(ref.shape, np.uint8)
    area_th = th if th >= 0 else 0
    for sl in ndimage.find_objects(labels):
        if sl is not None and (sl[0].stop - sl[0].start) * (sl[1].stop - sl[1].start) > area_th:
            mask[sl] = 255
    return mask


def calculate_motion_precision(frames: np.ndarray, mask: np.ndarray) -> float:
    """The share of actually moved pixels that fall inside the requested mask
    (1.0 when nothing moved)."""
    moved = get_moved_area_mask(frames, move_th=20, th=0) == 255
    denom = moved.sum()
    if denom == 0:
        return 1.0
    return float((moved & (mask == 255)).sum() / denom)
