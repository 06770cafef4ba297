"""The per-layer readers and the trace reduction on a synthetic trace."""

import pytest

from perfbench.harness import registry, trace

MS = 1_000_000  # ns


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0, ua=False):
        self._v = (name, dev, start, dur, corr, ua)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def synthetic() -> trace.Profile:
    """A 100 ms request: kernels busy over [10, 30) ∪ [25, 50) ∪ [60, 90) ms,
    an ln_geglu call launching two program kernels (4 + 6 ms), a tap_conv
    call launching one (10 ms) and a memset, an aten op colliding on a
    correlation id."""
    ev = [
        _Ev("perfbench.request", "CPU", 0, 100 * MS, 1, True),
        _Ev("perfbench.unet", "CPU", 5 * MS, 50 * MS, 2, True),
        _Ev("perfbench.call.ln_geglu", "CPU", 6 * MS, 2 * MS, 3, True),
        _Ev("cudaLaunchKernel", "CPU", 6 * MS + 10, 100, 101),
        _Ev("cudaLaunchKernel", "CPU", 7 * MS, 100, 102),
        _Ev("perfbench.call.tap_conv", "CPU", 20 * MS, 2 * MS, 4, True),
        _Ev("cudaLaunchKernel", "CPU", 20 * MS + 10, 100, 103),
        _Ev("cudaMemsetAsync", "CPU", 21 * MS, 100, 104),
        _Ev("aten::as_strided", "CPU", 21 * MS, 100, 105),
        _Ev("cudaLaunchKernel", "CPU", 58 * MS, 100, 105),
        _Ev("void aat::gemm::layer_norm_kernel<8>", "CUDA", 10 * MS, 4 * MS, 101),
        _Ev("void aat::gemm::tma_gemm_kernel<256>", "CUDA", 14 * MS, 6 * MS, 102),
        _Ev("void aat::tap_conv_kernel", "CUDA", 20 * MS, 10 * MS, 103),
        _Ev("Memset (Device)", "CUDA", 25 * MS, 25 * MS, 104),
        _Ev("void at::native::elementwise", "CUDA", 60 * MS, 30 * MS, 105),
        _Ev("perfbench.request", "CUDA", 10 * MS, 80 * MS, 1, True),
    ]
    return trace.Profile(_Prof(ev), "perfbench.request")


def test_union_of_intervals():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 9), (10, 11)]) == [[0, 3], [5, 9], [10, 11]]
    p = synthetic()
    assert p.window_s == pytest.approx(0.1)
    assert p.busy_s == pytest.approx(0.070)      # [10, 50) and [60, 90)
    assert p.program_kernels() == 3


def test_kernel_time_of_a_range():
    p = synthetic()
    assert p.kernel_s_in("perfbench.call.ln_geglu") == pytest.approx(0.010)
    assert p.kernel_s_in("perfbench.call.tap_conv") == pytest.approx(0.035)  # kernel + memset
    assert p.kernel_s_in("perfbench.nothing") == 0.0


def test_idle_gaps_by_the_host_range():
    gaps = dict(synthetic().idle_gaps())
    # [0, 10) and [50, 55) in unet... [0, 5) request, [5, 10) unet, [50, 55) unet,
    # [55, 60) request, [90, 100) request
    assert gaps["unet"] == pytest.approx(0.010)
    assert gaps["request"] == pytest.approx(0.020)
    top = synthetic().top_ops(2)
    assert top[0][0] == "void at::native::elementwise" and top[0][1] == pytest.approx(0.03)


def _read(name, records):
    return registry.metric_module(name).read(records)


def test_readers():
    p = synthetic()
    rec = {"profile": p, "spans": {"unet": [170.0, 174.0], "vae_decode": [200.0]},
           "calls": {"ln_geglu": [0.001, 0.002], "tap_conv": [0.007]},
           "item_s": 0.2, "item_flops": 1.0e14, "peak_flops": 5.0e15}
    assert _read("unet_forward_ms", rec) == pytest.approx(172.0)
    assert _read("vae_decode_ms", rec) == pytest.approx(200.0)
    assert _read("ln_geglu_roofline", rec) == pytest.approx(30.0)
    assert _read("tap_conv_roofline", rec) == pytest.approx(20.0)
    # the traced interval's own 100 ms, not an unprofiled item's 200 ms
    assert _read("idle_share.request", rec) == pytest.approx(30.0)
    assert _read("idle_share.train", rec) == pytest.approx(30.0)
    assert _read("mfu.request", rec) == pytest.approx(10.0)


def test_readers_find_nothing():
    empty = {"spans": {}, "calls": {}, "profile": None, "item_s": None}
    for name in ("unet_forward_ms", "vae_decode_ms", "ln_geglu_roofline",
                 "tap_conv_roofline", "idle_share.request", "mfu.request"):
        assert _read(name, empty) is None
