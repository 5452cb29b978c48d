"""Model code of the port: the dense LM family's full-sequence forward and
prefill, its paged serving path, and its dense-cache decode (burst engine
and speculative draft)."""

from .attention import (
    ATTN_IMPLS,
    FULL_IMPLS,
    KV_QUANT_MAX,
    KV_SCALE_EPS,
    dequantise_kv_rows,
    quantise_kv_rows,
)
from .model import (
    chunked_decode_step,
    copy_cache_pages,
    decode_step,
    draft_view,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    layer_params,
    paged_decode_step,
    paged_prefill_step,
    paged_verify_step,
    pad_cache,
    prefill,
)

__all__ = [
    "ATTN_IMPLS",
    "FULL_IMPLS",
    "KV_QUANT_MAX",
    "KV_SCALE_EPS",
    "chunked_decode_step",
    "copy_cache_pages",
    "decode_step",
    "dequantise_kv_rows",
    "draft_view",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "layer_params",
    "paged_decode_step",
    "paged_prefill_step",
    "paged_verify_step",
    "pad_cache",
    "prefill",
    "quantise_kv_rows",
]
