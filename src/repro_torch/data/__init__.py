"""Host data pipeline of the port (a copy of the JAX package's)."""
