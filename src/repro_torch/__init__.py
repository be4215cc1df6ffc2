"""PyTorch and CUDA port of the Libra reproduction.

The batched selective-copy datapath (``repro_torch.core``) runs its device
rounds on an NVIDIA H100 through four hand-written CUDA kernels
(``repro_torch.kernels``). The JAX package ``repro`` is the reference this
port is held against; this package imports nothing of it.
"""
