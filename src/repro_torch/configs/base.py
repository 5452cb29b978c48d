"""ArchConfig: declarative architecture definitions (copy of ``repro.configs.base``).

Every architecture is a frozen dataclass instance built from its published
numbers; reduced "smoke" variants of the same family are derived mechanically
for CPU tests. The port keeps its own copy so that it never imports ``repro``;
a full-width config is instantiated only on the GPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # mixer/mlp patterns, cycled over layers. mixers: attn | attn_local | mamba
    # mlps: mlp | moe | none
    layer_pattern: tuple = ("attn",)
    mlp_pattern: tuple = ("mlp",)
    # attention options
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    # norms / activations
    norm: str = "rmsnorm"  # rmsnorm | ln_nonparam
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    # MoE
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_kernel: int = 4
    # io
    input_kind: str = "tokens"  # tokens | embeddings (stub modality frontend)
    tie_embeddings: bool = False
    embed_scale: bool = False
    # infra hints
    zero_over_pod: bool = False  # shard optimizer state over the pod axis too
    remat: str = "block"  # none | block
    dtype: str = "bfloat16"
    source: str = ""

    # ------------------------------------------------------------ derived
    @property
    def period(self) -> int:
        return math.lcm(len(self.layer_pattern), len(self.mlp_pattern))

    def mixer_at(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def mlp_at(self, i: int) -> str:
        return self.mlp_pattern[i % len(self.mlp_pattern)]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return any(m.startswith("attn") for m in self.layer_pattern)

    def validate(self) -> "ArchConfig":
        assert self.num_layers % self.period == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {self.period}"
        )
        if self.has_attention:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if "moe" in self.mlp_pattern:
            assert self.num_experts > 1 and self.top_k >= 1
        if "mamba" in self.layer_pattern:
            assert self.ssm_state > 0
            assert self.ssm_d_inner % self.ssm_headdim == 0
        return self

    # ------------------------------------------------------------ reduced
    def smoke(self) -> "ArchConfig":
        """Mechanically reduced same-family config for CPU smoke tests."""
        period = self.period
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=period if period > 1 else 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=32 if self.num_experts else 0,
            sliding_window=16 if self.sliding_window else None,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 256,
            remat="none",
            dtype="float32",
        ).validate()


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    cfg = cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import the module of the same name to trigger registration
        import importlib

        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]
