"""Data-sheet peaks of one NVIDIA H100 SXM (80 GB HBM3; dense rates, no
sparsity; at its full 700 W power limit).  Every MFU is taken against the
dense bf16 rate whatever the cell's precision, so no emulation of float32
on the tensor cores can read over 100%; float32 runs at 67 TFLOP/s on the
CUDA cores, 495 in TF32 and about 165 as three TF32 products."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # the CUDA cores: the semi-CRF kernels' operation bound
