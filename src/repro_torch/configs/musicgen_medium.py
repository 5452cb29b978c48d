"""musicgen-medium [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a stub; input_specs() provides
precomputed frame embeddings (input_kind="embeddings").
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,   # GQA kv=24 (i.e. MHA)
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    input_kind="embeddings",
    act="gelu",
    source="arXiv:2306.05284; hf",
))
