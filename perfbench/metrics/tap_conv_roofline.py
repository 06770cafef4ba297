"""Kernel 3's function, ops/temporal_conv.py::gn_silu_tap_conv: its calls' least time over the device time they launched, in the profiled request."""

from perfbench.metrics._common import roofline_pct


def read(records: dict):
    return roofline_pct(records, "tap_conv")
