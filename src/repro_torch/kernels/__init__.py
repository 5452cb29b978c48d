"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``paged_decode_attention`` (B1) and ``paged_prefill_attention`` (B2) carry
the paged serving path's attention over model-dtype pages;
``paged_decode_attention_int8`` (B3) and ``paged_prefill_attention_int8``
(B4) over int8 pages with per-row scales (B2 and B4 also serve the verify
lane). Their wrappers run the plain version on CPU tensors and launch the
kernel on CUDA tensors; ``launches`` on each wrapper counts kernel launches.
"""

from .decode_attention import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_plain,
    paged_decode_attention_plain,
)
from .prefill_attention import (
    paged_prefill_attention,
    paged_prefill_attention_int8,
    paged_prefill_attention_int8_plain,
    paged_prefill_attention_plain,
)

KERNELS = (
    paged_decode_attention,
    paged_prefill_attention,
    paged_decode_attention_int8,
    paged_prefill_attention_int8,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "paged_decode_attention",
    "paged_decode_attention_int8",
    "paged_decode_attention_int8_plain",
    "paged_decode_attention_plain",
    "paged_prefill_attention",
    "paged_prefill_attention_int8",
    "paged_prefill_attention_int8_plain",
    "paged_prefill_attention_plain",
    "reset_launch_counts",
]
