"""The numbers that decide ``correct``: gaps between what the timed path
produced and the plain reference, each held to its limit."""

from __future__ import annotations

import math

import torch


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ over all elements, in float64."""
    g, w = got.double(), want.double().to(got.device)
    if g.shape != w.shape:
        raise ValueError(f"shape {tuple(g.shape)} against the reference's {tuple(w.shape)}")
    den = torch.linalg.vector_norm(w)
    return float(torch.linalg.vector_norm(g - w) / den.clamp_min(1e-30))


def worst(values) -> float:
    """The largest of the gaps; infinite where any is not finite."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """→ (all within their limits, name → {value, limit}). A number with no
    limit, or not finite, fails."""
    table, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": value if math.isfinite(value) else repr(value), "limit": limit}
    missing = [n for n in limits if n not in numbers]
    for name in missing:
        ok = False
        table[name] = {"value": None, "limit": limits[name]}
    return ok, table


def leaf_gap(got: dict, want: dict, ref_grads: dict, share: float) -> float:
    """The worst leaf's gap between two norms, |‖got‖ − ‖want‖|, as
    ``leaf_worst`` scales it."""
    return leaf_worst({k: abs(got[k] - want[k]) for k in want}, want, ref_grads, share)


def leaf_worst(gaps: dict, want: dict, ref_grads: dict, share: float) -> float:
    """The worst leaf's gap over the larger of the reference's norm of that
    leaf and of the median leaf; leaves whose reference gradient is under
    ``share`` of the median leaf's (nought to rounding, moved by round-off
    alone) are left out."""
    import statistics

    floor = share * statistics.median(ref_grads.values())
    keep = [k for k in want if ref_grads[k] >= floor]
    if not keep:
        raise ValueError("no leaf has a gradient")
    med = statistics.median(want[k] for k in keep)
    return worst(gaps[k] / max(want[k], med) for k in keep)
