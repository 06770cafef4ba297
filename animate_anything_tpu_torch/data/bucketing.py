"""Aspect-ratio bucketing — a copy of ``animate_anything_tpu/data/bucketing.py``:
snap a native video aspect onto the nearest 64/128-multiple bucket ≥ 192 px
on the varying side; the fixed side keeps the configured size.
"""

from __future__ import annotations


def _closest_bucket(target: float, min_size: int = 192) -> int:
    candidates = [max(int(round(target / m) * m), min_size) for m in (64, 128)]
    return min(candidates, key=lambda c: abs(c - target))


def sensible_buckets(m_width: int, m_height: int, w: int, h: int, min_size: int = 192):
    """(model_w, model_h, native_w, native_h) → (bucket_w, bucket_h)."""
    if h > w:  # portrait: height fixed at model size, width bucketed
        scaled_w = m_width / (h / w)
        return _closest_bucket(scaled_w, min_size), m_height
    if w > h:  # landscape
        scaled_h = m_height / (w / h)
        return m_width, _closest_bucket(scaled_h, min_size)
    return m_width, m_height
