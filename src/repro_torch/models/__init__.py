"""Model code of the port: the dense and MoE LM families' and the Mamba-2
(SSM) family's full-sequence forward and prefill, the attention families'
paged serving path, the training loss, and the dense-cache decode (burst engine, dense
continuous engine and speculative draft; an SSM slot's recurrent state),
and the dense family's serving paths over a mesh of logical devices
(``tensor_parallel``)."""

from .attention import (
    ATTN_IMPLS,
    FULL_IMPLS,
    KV_QUANT_MAX,
    KV_SCALE_EPS,
    dense_page_size,
    dense_page_view,
    dense_rows,
    dequantise_kv_rows,
    quantise_kv_rows,
)
from .model import (
    MOE_AUX_WEIGHT,
    check_paged,
    chunked_decode_step,
    chunked_verify_step,
    copy_cache_pages,
    decode_step,
    draft_view,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    input_specs,
    layer_params,
    loss_fn,
    paged_decode_step,
    paged_prefill_step,
    paged_verify_step,
    pad_cache,
    prefill,
)
from .moe import POLICIES as MOE_POLICIES
from .ssm import init_ssm_cache, ssd_scan, ssm_apply, ssm_decode_step
from .tensor_parallel import ShardedCache, relayout_cache

__all__ = [
    "ATTN_IMPLS",
    "FULL_IMPLS",
    "KV_QUANT_MAX",
    "KV_SCALE_EPS",
    "MOE_AUX_WEIGHT",
    "MOE_POLICIES",
    "ShardedCache",
    "check_paged",
    "chunked_decode_step",
    "chunked_verify_step",
    "copy_cache_pages",
    "decode_step",
    "dense_page_size",
    "dense_page_view",
    "dense_rows",
    "dequantise_kv_rows",
    "draft_view",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "input_specs",
    "init_ssm_cache",
    "layer_params",
    "loss_fn",
    "paged_decode_step",
    "paged_prefill_step",
    "paged_verify_step",
    "pad_cache",
    "prefill",
    "quantise_kv_rows",
    "relayout_cache",
    "ssd_scan",
    "ssm_apply",
    "ssm_decode_step",
]
