"""The seven kernels: CUDA C++ for sm_90a (``csrc/``), their Python
wrappers (:mod:`.selective_copy`, :mod:`.attention`, :mod:`.mlstm_scan`),
plain PyTorch versions (:mod:`.ref`) and the ``impl`` dispatch
(:mod:`.ops`)."""
