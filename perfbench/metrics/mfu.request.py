"""One request's model FLOP (the reference's products at the cell's shapes) over its seconds after the profiled request, as a share of the bf16 peak."""

from perfbench.metrics._common import mfu_pct


def read(records: dict):
    return mfu_pct(records)
