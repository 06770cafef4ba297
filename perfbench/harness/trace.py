"""What the traced run records and how the profiler's events become the
records that the per-layer readers read.

- ``Spans``: CUDA events around each call of a named target (a module, by
  its forward hooks, or a function held as a module attribute), timed
  after the window, and ``torch.profiler.record_function`` ranges named
  ``perfbench.<name>`` around the same calls.
- ``Calls``: the roofline functions wrapped in ``perfbench.call.<name>``
  ranges, each call's least time from its shapes appended as it is made.
- ``Profile``: one profiled interval (a request or two steps): the device
  operations, their launches (joined by the CUPTI correlation id), the
  ranges; the union of busy intervals, the idle gaps by the innermost range
  the host was in, the device time of the kernels a range launched, and
  the kernels of the program (``aat::``) against its launch counters.
"""

from __future__ import annotations

import importlib
import pkgutil
import sys
from contextlib import contextmanager

import torch

PREFIX = "perfbench."
PROGRAM_KERNEL = "aat::"   # the namespace of the port's hand-written kernels


class Spans:
    """CUDA-event timings of named calls; ``ms(name)`` after a synchronize."""

    def __init__(self):
        self.events: dict = {}
        self.active = True
        self._undo = []

    def _start(self, name):
        if not self.active:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rf = torch.autograd.profiler.record_function(PREFIX + name)
        rf.__enter__()
        return ev, rf

    def _stop(self, name, token):
        if token is None:
            return
        ev0, rf = token
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        rf.__exit__(None, None, None)
        self.events.setdefault(name, []).append((ev0, ev1))

    def module(self, name: str, module: torch.nn.Module) -> None:
        stack = []

        def pre(_m, _args):
            stack.append(self._start(name))

        def post(_m, _args, _out):
            self._stop(name, stack.pop())

        self._undo.append(module.register_forward_pre_hook(pre).remove)
        self._undo.append(module.register_forward_hook(post).remove)

    def function(self, name: str, owner, attr: str) -> None:
        orig = getattr(owner, attr)

        def wrapped(*args, **kw):
            token = self._start(name)
            try:
                return orig(*args, **kw)
            finally:
                self._stop(name, token)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def clear(self) -> None:
        self.events.clear()

    def ms(self, name: str) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()


class Calls:
    """Wraps each roofline function where the program calls it: a range
    ``perfbench.call.<name>`` around the call and its least time appended."""

    def __init__(self):
        self.bounds: dict = {}
        self._undo = []

    def wrap(self, name: str, owner, attr: str, bound_s) -> None:
        orig = getattr(owner, attr)
        bounds = self.bounds.setdefault(name, [])

        def wrapped(*args, **kw):
            bounds.append(bound_s(*args, **kw))
            with torch.autograd.profiler.record_function(f"{PREFIX}call.{name}"):
                return orig(*args, **kw)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def mark(self) -> dict:
        return {k: len(v) for k, v in self.bounds.items()}

    def since(self, mark: dict) -> dict:
        return {k: v[mark.get(k, 0):] for k, v in self.bounds.items()}

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()


def launch_counters() -> dict:
    """The program's launch counters: every ``launches`` / ``bwd_launches``
    integer of a loaded module of its ``ops`` package (each call launches
    one kernel or more)."""
    out = {}
    try:
        ops = importlib.import_module("animate_anything_tpu_torch.ops")
    except ImportError:
        return out
    for info in pkgutil.iter_modules(ops.__path__):
        mod = sys.modules.get(f"{ops.__name__}.{info.name}")
        if mod is None:
            continue
        for attr in ("launches", "bwd_launches"):
            v = getattr(mod, attr, None)
            if isinstance(v, int):
                out[f"{info.name}.{attr}"] = v
    return out


@contextmanager
def profiled(name: str):
    """A profiler over the block, and a ``perfbench.<name>`` range that
    bounds the interval (closed after a synchronize). ``holder["reduce"]()``
    gives the ``Profile``: call it once the window has closed."""
    from torch.profiler import ProfilerActivity, profile

    holder = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.autograd.profiler.record_function(PREFIX + name):
            yield holder
            torch.cuda.synchronize()
    holder["reduce"] = lambda: Profile(prof, PREFIX + name)


def _union(intervals):
    """Sorted, merged [start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Profile:
    """One profiled interval, reduced to what the readers need (ns)."""

    def __init__(self, prof, window_name: str):
        self.device_ops = []     # (name, start, end, correlation)
        self.launch_ns = {}      # correlation -> host time of the launch call
        self.ranges = []         # (name, start, end), host side
        window = None
        for e in prof.profiler.kineto_results.events():
            dev = str(e.device_type())
            start, dur = e.start_ns(), e.duration_ns()
            name = e.name()
            if dev.endswith("CPU"):
                if e.is_user_annotation():
                    if name == window_name:
                        window = (start, start + dur)
                    self.ranges.append((name, start, start + dur))
                elif name.startswith("cu"):   # a runtime or driver call
                    self.launch_ns[e.correlation_id()] = start
            elif not e.is_user_annotation():
                self.device_ops.append((name, start, start + dur, e.correlation_id()))
        if window is None:
            raise RuntimeError(f"the trace holds no {window_name} range")
        self.window = window
        lo, hi = window
        self.device_ops = [op for op in self.device_ops if op[2] > lo and op[1] < hi]
        self.busy = _union((max(s, lo), min(e, hi)) for _, s, e, _ in self.device_ops)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def program_kernels(self) -> int:
        return sum(1 for op in self.device_ops if PROGRAM_KERNEL in op[0])

    def kernel_s_in(self, range_name: str) -> float:
        """Device seconds of every operation launched while the host was
        inside a range named ``range_name``."""
        spans = _union((s, e) for n, s, e in self.ranges if n == range_name)
        if not spans:
            return 0.0
        import bisect

        starts = [s for s, _ in spans]
        total = 0
        for _, s, e, corr in self.device_ops:
            t = self.launch_ns.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                total += e - s
        return total * 1e-9

    def top_ops(self, k: int = 10) -> list:
        sums: dict = {}
        for name, s, e, _ in self.device_ops:
            sums[name] = sums.get(name, 0) + (e - s)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time in the window, by the innermost benchmark range the host
        was in when each gap began."""
        lo, hi = self.window
        edges = [lo] + [x for pair in self.busy for x in pair] + [hi]
        ours = sorted(((s, -e, n) for n, s, e in self.ranges if n.startswith(PREFIX)))
        sums: dict = {}
        stack, at = [], 0        # the ranges open at the gap's start, innermost last
        for i in range(0, len(edges), 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 <= g0:
                continue
            while at < len(ours) and ours[at][0] <= g0:
                stack.append((-ours[at][1], ours[at][2]))
                at += 1
            while stack and stack[-1][0] <= g0:
                stack.pop()
            name = stack[-1][1][len(PREFIX):] if stack else "outside"
            sums[name] = sums.get(name, 0) + (g1 - g0)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns * 1e-9] for name, ns in top]
