"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
data sheet; dense rates, no sparsity), which assume the card's full 700 W
power limit: each run prints the limit it ran under."""

TENSOR_FLOPS = 989e12       # bf16 / fp16 dense tensor-core FLOP/s
FP32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12   # HBM3 bytes/s
