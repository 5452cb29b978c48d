"""Model code of the port: the paged serving path of the dense LM family and
the speculative draft's dense-cache path."""

from .attention import (
    ATTN_IMPLS,
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
    init_cache,
    init_paged_cache,
    init_params,
    layer_params,
    paged_decode_step,
    paged_prefill_step,
    paged_verify_step,
)

__all__ = [
    "ATTN_IMPLS",
    "KV_QUANT_MAX",
    "KV_SCALE_EPS",
    "chunked_decode_step",
    "copy_cache_pages",
    "decode_step",
    "dequantise_kv_rows",
    "draft_view",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "layer_params",
    "paged_decode_step",
    "paged_prefill_step",
    "paged_verify_step",
    "quantise_kv_rows",
]
