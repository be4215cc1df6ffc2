"""The kernels: CUDA C++ for sm_90a (``csrc/``), their Python wrappers
(:mod:`.selective_copy`, :mod:`.attention`, :mod:`.mlstm_scan` for the
seven TPU kernels, :mod:`.ktls_attention` for the kTLS-analogue bench's
two, :mod:`.linear_f32` for the prefill's float32 products), plain
PyTorch versions (:mod:`.ref`) and the ``impl`` dispatch (:mod:`.ops`)."""
