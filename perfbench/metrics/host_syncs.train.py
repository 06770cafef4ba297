"""The program's ``aat.sync`` spans (a read of a device value by the host, which waits for the device) inside its ``aat.train_step`` spans, over the count of those: the host syncs of one step."""

from perfbench.metrics import _program as P


def read(records: dict):
    prof = P.profile(records)
    if prof is None:
        return None
    steps = P.ranges(prof, "train_step")
    return len(P.within(P.ranges(prof, "sync"), steps)) / len(steps) if steps else None
