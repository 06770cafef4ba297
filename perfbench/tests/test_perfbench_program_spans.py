"""The readers of the program's own spans (``metrics/_program.py``) on
hand-built traces: a request with two UNet calls and a pair of train steps,
each metric against its value worked out by hand, and None where the trace
holds none of the program's ranges."""

import pytest

from perfbench.harness import registry, trace
from perfbench.tests.test_perfbench_trace import MS, _Ev, _Prof, synthetic

REQUEST = ("unet_idle_ms", "wrapper_idle_ms", "unet_launches")
TRAIN = ("forward_idle_ms", "backward_idle_ms", "host_syncs.train")


def _ua(name, start, end):
    return _Ev(name, "CPU", start * MS, (end - start) * MS, 0, True)


def request_trace() -> trace.Profile:
    """A 100 ms request: the device busy over [10, 50), [60, 90) and [98, 99)
    ms; UNet calls [5, 55) and [56, 95); wrappers [6, 8) and [52, 54) in
    the first, [57, 62) in the second and [96, 98) outside both; launches at
    7, 20 and 58 ms inside the calls and one at 97 outside."""
    ev = [_ua("perfbench.request", 0, 100), _ua("perfbench.unet", 5, 55),
          _ua("aat.request", 1, 99), _ua("aat.step", 4, 55),
          _ua("aat.unet", 5, 55), _ua("aat.unet", 56, 95),
          _ua("aat.op.ln_geglu_ff", 6, 8), _ua("aat.op.tap_conv", 52, 54),
          _ua("aat.op.temporal_block", 57, 62), _ua("aat.op.group_norm_silu", 96, 98)]
    for i, (at, start, end) in enumerate([(7, 10, 30), (20, 25, 50), (58, 60, 90),
                                          (97, 98, 99)]):
        ev.append(_Ev("cudaLaunchKernel", "CPU", at * MS, 10, 101 + i))
        ev.append(_Ev(f"void aat::k{i}", "CUDA", start * MS, (end - start) * MS, 101 + i))
    return trace.Profile(_Prof(ev), "perfbench.request")


def train_trace() -> trace.Profile:
    """Two 100 ms steps in a 210 ms window, each: inputs [0, 10), loss
    [10, 40), backward [40, 80), metrics [80, 85) with three syncs, the
    optimizer [85, 100) with one; the device busy over [5, 35) and [45, 75)
    of each; one more sync after the steps."""
    ev = [_ua("perfbench.steps", 0, 210), _ua("aat.sync", 205, 206)]
    for k in (0, 100):
        ev += [_ua("aat.train_step", k, k + 100), _ua("aat.inputs", k, k + 10),
               _ua("aat.encode", k + 2, k + 8), _ua("aat.loss", k + 10, k + 40),
               _ua("aat.backward", k + 40, k + 80), _ua("aat.metrics", k + 80, k + 85),
               _ua("aat.sync", k + 80, k + 82), _ua("aat.sync", k + 82, k + 83),
               _ua("aat.sync", k + 83, k + 84), _ua("aat.optimizer", k + 85, k + 100),
               _ua("aat.sync", k + 95, k + 96)]
        for start, end in ((5, 35), (45, 75)):
            ev.append(_Ev("void at::native::elementwise", "CUDA", (k + start) * MS,
                          (end - start) * MS, 0))
    return trace.Profile(_Prof(ev), "perfbench.steps")


def _read(name, prof):
    return registry.metric_module(name).read({"profile": prof})


@pytest.mark.parametrize("name, want", [
    ("unet_idle_ms", (10 + 9) / 2),     # [5, 10), [50, 55); [56, 60), [90, 95)
    ("wrapper_idle_ms", (2 + 2 + 3) / 2),  # [6, 8), [52, 54), [57, 60); not [96, 98)
    ("unet_launches", 3 / 2),            # at 7, 20 and 58; not at 97
])
def test_request_readers(name, want):
    assert _read(name, request_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("forward_idle_ms", (10 + 10) / 2),   # [0, 5) and [35, 40) a step
    ("backward_idle_ms", (10 + 10) / 2),  # [40, 45) and [75, 80) a step
    ("host_syncs.train", 8 / 2),          # the sync after the steps not counted
])
def test_train_readers(name, want):
    assert _read(name, train_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", REQUEST + TRAIN)
def test_readers_find_nothing_without_the_programs_spans(name):
    assert _read(name, None) is None
    assert _read(name, synthetic()) is None          # the benchmark's ranges alone
    other = train_trace() if name in REQUEST else request_trace()
    assert _read(name, other) is None
