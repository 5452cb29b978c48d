"""Training checkpoints in the JAX package's layout (``checkpoint.checkpoint``)."""
