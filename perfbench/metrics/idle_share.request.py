"""The profiled request's idle share of the device: 1 - the union of its device operations' intervals over the traced interval's own length."""

from perfbench.metrics._common import idle_pct


def read(records: dict):
    return idle_pct(records)
