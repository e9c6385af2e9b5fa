"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

BF16_FLOPS = 989e12  # tensor cores, bf16 inputs, f32 accumulation
F32_FLOPS = 67e12  # CUDA cores, float32 outside the tensor cores
HBM_BYTES_S = 3.35e12  # HBM3


def least_seconds(flops: float, n_bytes: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of compute and traffic."""
    return max(flops / flops_peak, n_bytes / HBM_BYTES_S)
