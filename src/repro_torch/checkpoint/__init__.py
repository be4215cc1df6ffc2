"""Atomic, asynchronous checkpoints in the JAX package's on-disk layout."""
