"""Model code of the port: the dense LM family's and the Mamba-2 (SSM)
family's full-sequence forward and prefill, the dense family's paged serving
path, and the dense-cache decode (burst engine and speculative draft; an SSM
slot's recurrent state)."""

from .attention import (
    ATTN_IMPLS,
    FULL_IMPLS,
    KV_QUANT_MAX,
    KV_SCALE_EPS,
    dequantise_kv_rows,
    quantise_kv_rows,
)
from .model import (
    check_paged,
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
from .ssm import init_ssm_cache, ssd_scan, ssm_apply, ssm_decode_step

__all__ = [
    "ATTN_IMPLS",
    "FULL_IMPLS",
    "KV_QUANT_MAX",
    "KV_SCALE_EPS",
    "check_paged",
    "chunked_decode_step",
    "copy_cache_pages",
    "decode_step",
    "dequantise_kv_rows",
    "draft_view",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "init_ssm_cache",
    "layer_params",
    "paged_decode_step",
    "paged_prefill_step",
    "paged_verify_step",
    "pad_cache",
    "prefill",
    "quantise_kv_rows",
    "ssd_scan",
    "ssm_apply",
    "ssm_decode_step",
]
