"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,          # per-expert ffn
    vocab_size=131072,
    mlp_pattern=("moe",),
    num_experts=8,
    top_k=2,
    expert_d_ff=32768,
    attn_logit_softcap=30.0,   # grok uses attn logit capping
    final_logit_softcap=30.0,
    zero_over_pod=True,
    source="hf:xai-org/grok-1; unverified",
))
