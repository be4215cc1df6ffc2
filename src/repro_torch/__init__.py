"""PyTorch and CUDA port of the Libra reproduction.

The batched selective-copy datapath (``repro_torch.core``), serving of the
dense LM under ``LibraEngine`` (``repro_torch.serving``, ``models``) and
prefill and decode of the xLSTM LM run on an NVIDIA H100 through seven
hand-written CUDA kernels (``repro_torch.kernels``), one for each Pallas
kernel of the JAX package ``repro``. That package is the reference this
port is held against; this package imports nothing of it.
"""
