"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit) that every roofline share and ``mfu`` is taken against."""

BF16_FLOPS = 989e12       # FLOP/s, bf16 and fp16 tensor cores
HBM_BYTES = 3.35e12       # bytes/s


def bound_s(flop: float, nbytes: float) -> float:
    """The least time of a call: the larger of its FLOP at the peak rate and
    its bytes (each input read once, each output written once) at the peak
    bandwidth."""
    return max(flop / BF16_FLOPS, nbytes / HBM_BYTES)
