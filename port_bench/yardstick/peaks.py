"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W power limit). Every roofline share and MFU of the
benchmark is taken against these; the run prints the card's power limit
beside them."""

PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16
PEAK_TF32_FLOPS = 495e12  # tensor cores, TF32
PEAK_F32_FLOPS = 67e12  # CUDA cores, f32
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of operations over the
    peak rate and bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
