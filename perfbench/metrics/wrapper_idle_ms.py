"""The device's idle ms inside the program's kernel-wrapper spans (``aat.op.*``, ``ops/*.py``) that lie inside its ``aat.unet`` spans, over the UNet calls: the share of ``unet_idle_ms`` spent in the wrappers."""

from perfbench.metrics import _program as P


def read(records: dict):
    prof = P.profile(records)
    if prof is None:
        return None
    ops = P.within(P.prefixed(prof, "op."), P.ranges(prof, "unet"))
    return P.per_ms(prof, ops, "unet")
