"""gemma2-27b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

The showcase arch for kernel-level semi-static specialisation: the local
(window=4096) and global layers are two *baked* kernel variants rather than one
runtime-predicated kernel (DESIGN.md 2).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
))
