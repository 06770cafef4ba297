"""The two profiled steps' idle share of the device: 1 - the union of their device operations' intervals over the traced interval's own length."""

from perfbench.metrics._common import idle_pct


def read(records: dict):
    return idle_pct(records)
