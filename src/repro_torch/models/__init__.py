"""Models of the port: the dense decoder-only LM that the serving slice
runs (``transformer``), its primitives (``layers``), attention paths
(``attention``), the registry and the carrier of JAX weights
(``convert``)."""
