"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit).  Every roofline share
and MFU of the benchmark is taken against these; each run records the
card's power limit beside them (``device.power_limit_w``)."""

BF16_FLOPS = 989e12        # FLOP/s, bf16 / fp16 tensor cores
F32_FLOPS = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BYTES = 3.35e12        # bytes/s


def bound_seconds(flops: float, n_bytes: float,
                  peak_flops: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, n_bytes / HBM_BYTES)
