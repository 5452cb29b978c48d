"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``paged_decode_attention`` (B1) and ``paged_prefill_attention`` (B2) carry
the paged serving path's attention. Their wrappers run the plain version on
CPU tensors and launch the kernel on CUDA tensors; ``launches`` on each
wrapper counts kernel launches.
"""

from .decode_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from .prefill_attention import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
)

KERNELS = (paged_decode_attention, paged_prefill_attention)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_prefill_attention",
    "paged_prefill_attention_plain",
    "reset_launch_counts",
]
