"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

8-layer period with attention at index 4 (Jamba's attn-layer-offset), MoE on
every other layer. Sub-quadratic enough for long_500k: SSM layers carry O(1)
state; the sparse attention layers' 512k KV cache shards over the data axis.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,          # per-expert ffn (dense layers use the same width)
    vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    mlp_pattern=("mlp", "moe"),
    num_experts=16,
    top_k=2,
    expert_d_ff=24576,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    zero_over_pod=True,
    source="arXiv:2403.19887; hf",
))
