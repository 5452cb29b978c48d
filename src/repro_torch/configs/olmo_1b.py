"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="ln_nonparam",
    tie_embeddings=True,
    source="arXiv:2402.00838; hf",
))
