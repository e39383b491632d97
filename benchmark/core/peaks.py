"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): float32 outside the tensor cores, and HBM3 bandwidth. Shares
are stated against these, with the card's power limit printed beside."""
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
