"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): float32 outside the tensor cores and HBM3 bandwidth.
A card held under a lower power limit reaches less; the benchmark prints
the limit beside its numbers."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
