"""Mean milliseconds of one request's VAE decode, by CUDA events around each call after the profiled request."""

from perfbench.metrics._common import mean_ms


def read(records: dict):
    return mean_ms(records, "vae_decode")
