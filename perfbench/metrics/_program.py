"""Shared arithmetic of the readers of the program's own spans: the ``aat.*``
ranges that the port opens as ``torch.profiler`` ranges around its layers
(the request, the sampler step, the UNet, the kernel wrappers ``aat.op.*``,
the train step's phases, each host sync), read from the traced run's
``Profile`` on the same clock as the device's operations. A program that
opens none leaves none in the trace, and every reader returns None.

"Idle inside X": the length of the union of X's ranges, within the
profiled interval, less the part that the union of the device's busy
intervals (``Profile.busy``) covers: the device waited while the host was
in X. "Launched inside X": the device operations (kernels, copies, memsets)
whose launch call the host made while inside one of X's ranges.
"""

from __future__ import annotations

import bisect

from perfbench.harness.trace import _union

PREFIX = "aat."


def ranges(prof, name: str) -> list:
    """The (start, end) of every range named ``aat.<name>``."""
    full = PREFIX + name
    return [(s, e) for n, s, e in prof.ranges if n == full]


def prefixed(prof, prefix: str) -> list:
    """The (start, end) of every range whose name starts ``aat.<prefix>``."""
    full = PREFIX + prefix
    return [(s, e) for n, s, e in prof.ranges if n.startswith(full)]


def within(inner: list, outer: list) -> list:
    """The ranges of ``inner`` that start inside a range of ``outer``."""
    merged = _union(outer)
    starts = [s for s, _ in merged]
    out = []
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < merged[i][1]:
            out.append((s, e))
    return out


def idle_ns(prof, spans: list) -> int:
    """The device's idle time inside the union of ``spans`` (ns)."""
    lo, hi = prof.window
    merged = _union((max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi)
    busy, covered, j = prof.busy, 0, 0
    for s, e in merged:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return sum(e - s for s, e in merged) - covered


def launched(prof, spans: list) -> int:
    """The device operations launched inside the union of ``spans``."""
    merged = _union(spans)
    starts = [s for s, _ in merged]
    count = 0
    for _, _, _, corr in prof.device_ops:
        t = prof.launch_ns.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        count += i >= 0 and t < merged[i][1]
    return count


def per_ms(prof, spans: list, per: str):
    """Idle ms inside ``spans``, over the count of ``aat.<per>`` ranges;
    None where the trace holds no ``aat.<per>``."""
    n = len(ranges(prof, per))
    return idle_ns(prof, spans) * 1e-6 / n if n else None


def profile(records: dict):
    return records.get("profile")
