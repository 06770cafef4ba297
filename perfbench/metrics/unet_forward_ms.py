"""Mean milliseconds of one call of the pipeline's UNet (a CFG pair), by CUDA events around each call after the profiled request."""

from perfbench.metrics._common import mean_ms


def read(records: dict):
    return mean_ms(records, "unet")
