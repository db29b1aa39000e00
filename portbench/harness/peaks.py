"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share of a
peak is stated against these, with the card's name and power limit
beside it."""

BF16_FLOPS = 989e12      # FLOP/s, bf16 and fp16 on the tensor cores
FP32_FLOPS = 67e12       # FLOP/s, fp32 outside the tensor cores
HBM_BYTES = 3.35e12      # bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES, flops / peak_flops)
