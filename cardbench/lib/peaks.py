"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A roofline share is taken at the
peak that could do the same exact work, whatever implements it: a sum of
+-1 terms of f32 values is exact on bf16 tensor cores accumulating in f32,
so the ternary products are held to the bf16 rate too."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip needs for the work: the larger of the
    operations over the peak rate and the bytes over the bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
