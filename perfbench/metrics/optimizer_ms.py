"""Mean milliseconds of one call of train/trainer.py::apply_gradients (the global-norm clip and AdamW on the fp32 masters, the masters rounded into the bf16 model), by CUDA events around each call after the profiled steps."""

from perfbench.metrics._common import mean_ms


def read(records: dict):
    return mean_ms(records, "optimizer")
