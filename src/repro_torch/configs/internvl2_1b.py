"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B backbone [arXiv:2404.16821; hf].

Backbone only: the InternViT frontend is a stub; input_specs() provides
precomputed patch embeddings (input_kind="embeddings").
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    input_kind="embeddings",
    rope_theta=1000000.0,
    source="arXiv:2404.16821; hf",
))
