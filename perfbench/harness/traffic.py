"""Pieces of the traffic generators that every configuration shares."""

from __future__ import annotations

import numpy as np


def rect_mask(rng: np.random.Generator, res: int, area_range) -> np.ndarray:
    """(res, res) uint8, 255 inside one rectangle of ``area_range`` of the
    image (aspect 1:2 to 2:1, at least 8 px a side), 0 elsewhere."""
    area = rng.uniform(*area_range) * res * res
    aspect = rng.uniform(0.5, 2.0)
    h = int(min(res, max(8, round((area / aspect) ** 0.5))))
    w = int(min(res, max(8, round(area / h))))
    y0, x0 = int(rng.integers(0, res - h + 1)), int(rng.integers(0, res - w + 1))
    mask = np.zeros((res, res), np.uint8)
    mask[y0:y0 + h, x0:x0 + w] = 255
    return mask
