"""Models of the port: the decoder-only LM of the dense, moe, hybrid and
vlm families (``transformer``, its MoE block in ``moe``, its Mamba mixer
in ``ssm``), the encoder-decoder (``encdec``) and the xLSTM LM
(``xlstm_model``, its mLSTM and sLSTM blocks in ``ssm``), their
primitives (``layers``), attention paths (``attention``), the registry
and the carrier of JAX weights (``convert``)."""
