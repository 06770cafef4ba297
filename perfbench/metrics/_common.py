"""Shared arithmetic of the per-layer readers. A reader gets the traced run's
records and returns its number, or None where it finds nothing to read."""

from __future__ import annotations

import statistics


def mean_ms(records: dict, span: str):
    values = records.get("spans", {}).get(span)
    return statistics.fmean(values) if values else None


def roofline_pct(records: dict, function: str):
    """Σ least time of the function's calls in the profiled interval ÷ the
    device time of every operation launched inside those calls, in %."""
    prof, bounds = records.get("profile"), records.get("calls", {}).get(function)
    if prof is None or not bounds:
        return None
    spent = prof.kernel_s_in(f"perfbench.call.{function}")
    return 100.0 * sum(bounds) / spent if spent > 0 else None


def mfu_pct(records: dict):
    """The item's model FLOP over its seconds, as a share of the bf16 peak."""
    if not records.get("item_s") or not records.get("item_flops"):
        return None
    return 100.0 * records["item_flops"] / records["item_s"] / records["peak_flops"]


def idle_pct(records: dict):
    """1 − the profiled interval's busy device seconds (the union of its
    device operations' intervals) over the interval's own length in the
    trace, in %. The profiler's host cost lengthens the interval, so this
    reads above an unprofiled run's idle share; the run prints that stretch
    beside it."""
    prof = records.get("profile")
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
