"""Motion metrics — the port of ``animate_anything_tpu/metrics/motion.py``.

- ``latent_motion_score``: 10·Σ_c mean|Δ_t latents|, the motion strength the
  trainer conditions on and its auxiliary loss compares;
- ``motion_mask_loss``: frame-difference magnitude outside the mask;
- ``masked_psnr``: PSNR over a masked region;
- ``get_moved_area_mask``: frame differencing, dilation and the bounding
  boxes of the connected moved regions, through the native helper
  (``data/native.py``) where it builds, else scipy.ndimage;
- ``calculate_motion_precision``: the share of moved pixels inside the
  requested mask, which the eval entry point reports;
- ``calculate_motion_score``: 10 × the mean HSV pixel distance of
  consecutive frames (cv2's HSV convention, H in [0, 180]), native or numpy,
  which the datasets' motion threshold reads.

The first three take tensors and stay differentiable; the pixel metrics
take uint8 frames on the host.
"""

from __future__ import annotations

from typing import Optional

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


def masked_psnr(a: torch.Tensor, b: torch.Tensor, mask: Optional[torch.Tensor] = None,
                max_val: float = 2.0) -> torch.Tensor:
    """PSNR over the masked region; a, b in [-1, 1] by default (max_val 2)."""
    if mask is None:
        mse = (a - b).square().mean()
    else:
        w = torch.broadcast_to(mask, a.shape)
        mse = (w * (a - b).square()).sum() / w.sum().clamp_min(1.0)
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def _dilate(binary: np.ndarray, iterations: int, size: int = 3) -> np.ndarray:
    struct = np.ones((size, size), bool)
    return ndimage.binary_dilation(binary, structure=struct, iterations=iterations)


def get_moved_area_mask(frames: np.ndarray, move_th: float = 5.0,
                        th: float = -1.0, use_native: bool = True) -> np.ndarray:
    """frames (f, h, w, 3) uint8 → (h, w) uint8 {0, 255} mask of moved boxes:
    |Δ| of the gray frames against the first and the previous frame above
    ``move_th``, accumulated, dilated twice, then the bounding box of every
    connected component whose area exceeds ``th`` painted. The native
    helper where it builds (its gray is fp32, this path's fp64: the two can
    part at a threshold tie), else numpy."""
    if use_native and frames.dtype == np.uint8:
        from animate_anything_tpu_torch.data import native

        out = native.moved_area_mask(frames, move_th, int(th if th >= 0 else 0))
        if out is not None:
            return out
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


def _rgb_to_hsv_cv2(img: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2-convention HSV from uint8 RGB: H in [0, 180], S, V in [0, 255]."""
    rgb = img.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(-1)
    c = v - rgb.min(-1)
    s = np.where(v > 0, c / np.maximum(v, 1e-12), 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.select(
            [c == 0, v == r, v == g],
            [0.0,
             60.0 * ((g - b) / np.maximum(c, 1e-12)),
             120.0 + 60.0 * ((b - r) / np.maximum(c, 1e-12))],
            240.0 + 60.0 * ((r - g) / np.maximum(c, 1e-12)),
        )
    h = np.mod(h, 360.0) / 2.0
    return h.astype(np.float32), (s * 255).astype(np.float32), (v * 255).astype(np.float32)


def _mean_pixel_distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float32) - b.astype(np.float32)).mean())


def calculate_motion_score(frames: np.ndarray, use_native: bool = True) -> int:
    """frames (f, h, w, 3) uint8 RGB → round(10 × the mean HSV pixel distance
    of consecutive frames); the native helper where it builds, else numpy."""
    if len(frames) < 2:
        return 0
    if use_native and np.asarray(frames).dtype == np.uint8:
        from animate_anything_tpu_torch.data import native

        score = native.motion_score(np.asarray(frames))
        if score is not None:
            return score
    last = None
    score = 0.0
    for frame in frames:
        hsv = _rgb_to_hsv_cv2(frame)
        if last is not None:
            score += sum(_mean_pixel_distance(x, y) for x, y in zip(hsv, last)) / 3.0
        last = hsv
    return round(score / (len(frames) - 1) * 10)
