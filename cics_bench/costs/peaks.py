"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit): the yardstick of every roofline
share. The card's own power limit is reported beside each share."""

FP32_FLOPS = 67e12          # FP32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12         # HBM3 bandwidth, bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory bandwidth."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
