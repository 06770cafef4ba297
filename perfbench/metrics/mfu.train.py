"""Two steps' model FLOP (the reference's forward and backward products at the cell's shapes, no recomputation, and the encodes) over two unprofiled steps' seconds, as a share of the bf16 peak."""

from perfbench.metrics._common import mfu_pct


def read(records: dict):
    return mfu_pct(records)
