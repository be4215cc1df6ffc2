"""Batched-datapath kernels: CUDA C++ for sm_90a (``csrc/``), their Python
wrappers (:mod:`.selective_copy`), plain PyTorch versions (:mod:`.ref`) and
the ``impl`` dispatch (:mod:`.ops`)."""
