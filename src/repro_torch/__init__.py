"""PyTorch and CUDA port of the Libra reproduction.

The batched selective-copy datapath (``repro_torch.core``), serving of
every model family of the JAX package (``repro_torch.models``; the
decoder-only LMs under ``LibraEngine`` and the baselines,
``repro_torch.serving``) run on an NVIDIA H100 through seven
hand-written CUDA kernels (``repro_torch.kernels``), one for each Pallas
kernel of the JAX package ``repro``. That package is the reference this
port is held against; this package imports nothing of it.
"""
