"""The table of peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit (the card's limit is
printed beside every run's numbers)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12          # bf16 and fp16 tensor cores
TF32_FLOPS = 495e12          # TF32 tensor cores: the bound of any
                             # float32-accurate product (3xTF32 included)
F32_FLOPS = 67e12            # float32 outside the tensor cores
MFU_PEAK = BF16_FLOPS        # every mfu metric's denominator


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory's rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
