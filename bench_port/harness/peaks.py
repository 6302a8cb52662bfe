"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

#: bf16 / fp16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
