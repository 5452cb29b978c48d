"""Model code of the port: the paged serving path of the dense LM family."""

from .attention import ATTN_IMPLS
from .model import (
    copy_cache_pages,
    init_paged_cache,
    init_params,
    layer_params,
    paged_decode_step,
    paged_prefill_step,
)

__all__ = [
    "ATTN_IMPLS",
    "copy_cache_pages",
    "init_paged_cache",
    "init_params",
    "layer_params",
    "paged_decode_step",
    "paged_prefill_step",
]
