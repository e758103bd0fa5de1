"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_seconds(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory bandwidth and operations over the compute peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
