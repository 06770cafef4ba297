"""The device's idle ms inside the program's ``aat.inputs`` and ``aat.loss`` spans (the batch, the draws, the in-step encodes and the forward with its loss), over the ``aat.train_step`` spans of the profiled steps."""

from perfbench.metrics import _program as P


def read(records: dict):
    prof = P.profile(records)
    if prof is None:
        return None
    return P.per_ms(prof, P.ranges(prof, "inputs") + P.ranges(prof, "loss"), "train_step")
