"""NVIDIA H100 SXM5 (80 GB) constants for the roofline model, per GPU.

Source: NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column (dense
figures, i.e. without 2:4 structured sparsity), and its NVLink / NDR
InfiniBand figures. These are the card's peaks; a card set below its
700 W limit runs slower under load (``nvidia-smi`` prints the limit).
"""

PEAK_FLOPS_BF16 = 989e12       # 989 TFLOP/s bfloat16 tensor cores, dense
HBM_BW = 3.35e12               # 3.35 TB/s HBM3
HBM_BYTES = 80e9               # 80 GB HBM3
NVLINK_BW = 450e9              # 900 GB/s NVLink 4 total = 450 GB/s a direction
IB_BW = 50e9                   # one NDR 400 Gb/s InfiniBand port per GPU
