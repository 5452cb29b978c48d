"""hft-demo — the paper's own workload as a config.

The paper's scenario is a latency-critical order path: per market event,
run a small model over recent book state and branch between send/adjust
(paper Fig. 16/17). This stand-in is a tiny decoder over order-flow events
(vocab = event kinds); it is NOT one of the 10 assigned archs. In the port
it is the fp32, head_dim-64 config: B1-B7 run their CUDA-core bodies on it.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hft-demo",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=512,          # order-event vocabulary
    sliding_window=128,      # only recent book state matters
    layer_pattern=("attn_local",),
    rope_theta=10000.0,
    remat="none",
    dtype="float32",
    source="paper §4.4 scenario (synthetic stand-in)",
))
