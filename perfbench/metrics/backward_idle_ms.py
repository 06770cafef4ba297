"""The device's idle ms inside the program's ``aat.backward`` spans (the backward with its recomputation), over the ``aat.train_step`` spans of the profiled steps."""

from perfbench.metrics import _program as P


def read(records: dict):
    prof = P.profile(records)
    return None if prof is None else P.per_ms(prof, P.ranges(prof, "backward"), "train_step")
