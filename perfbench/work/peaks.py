"""Published peaks of one NVIDIA H100 SXM5 80 GB (data sheet, dense rates,
700 W). Every roofline share and MFU here is taken against the bf16 dense
peak, so a later lower-precision path can never read above 100%."""
HBM_BW = 3.35e12  # B/s
PEAK_FLOPS = 989e12  # bf16 / fp16, tensor cores, dense


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call can take: the larger of its operations over the
    peak rate and its bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)
