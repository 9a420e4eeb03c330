"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A run states the card's own power limit
beside every share of these (`nvidia-smi`'s power.limit)."""

FP32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES = 3.35e12         # HBM3 bytes/s
