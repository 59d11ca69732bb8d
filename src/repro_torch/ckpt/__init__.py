"""Atomic checkpoints of tensor trees (the JAX package's ``ckpt/``)."""
