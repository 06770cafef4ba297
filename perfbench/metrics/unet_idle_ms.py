"""The device's idle ms inside the program's ``aat.unet`` spans (``UNet3DConditionModel.forward`` and the SVD UNet's), over their count: one CFG call each, in the profiled request."""

from perfbench.metrics import _program as P


def read(records: dict):
    prof = P.profile(records)
    return None if prof is None else P.per_ms(prof, P.ranges(prof, "unet"), "unet")
