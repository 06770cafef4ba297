"""Kernel 2's function, ops/geglu.py::ln_geglu_ff: its calls' least time over the device time they launched, in the profiled request."""

from perfbench.metrics._common import roofline_pct


def read(records: dict):
    return roofline_pct(records, "ln_geglu")
