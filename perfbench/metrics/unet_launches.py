"""The device operations (kernels, copies, memsets) that the host launched inside the program's ``aat.unet`` spans, over their count: the launches of one CFG call of the UNet, in the profiled request."""

from perfbench.metrics import _program as P


def read(records: dict):
    prof = P.profile(records)
    if prof is None:
        return None
    unet = P.ranges(prof, "unet")
    return P.launched(prof, unet) / len(unet) if unet else None
