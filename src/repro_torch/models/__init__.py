"""Models of the port: the dense decoder-only LM that ``LibraEngine``
serves (``transformer``) and the xLSTM LM (``xlstm_model``, its mLSTM and
sLSTM blocks in ``ssm``), their primitives (``layers``), attention paths
(``attention``), the registry and the carrier of JAX weights
(``convert``)."""
