"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free; d_ff=0 (the Mamba2 block subsumes the MLP). The paper's
host-level semi-static construct still applies (dispatch layer); the kernel-level
story is chunk-size specialisation of the SSD scan: the chunk length is a
template parameter of the CUDA kernel (``csrc/ssd_chunk.cu``).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("mamba",),
    mlp_pattern=("none",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
