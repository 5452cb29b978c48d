"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``paged_decode_attention`` (B1) and ``paged_prefill_attention`` (B2) carry
the paged serving path's attention over model-dtype pages;
``paged_decode_attention_int8`` (B3) and ``paged_prefill_attention_int8``
(B4) over int8 pages with per-row scales (B2 and B4 also serve the verify
lane). ``decode_attention`` (B5) is the burst engine's dense decode at a
scalar position; ``flash_attention`` (B6) carries ``prefill``/``forward``,
and ``flash_attention_branchy`` (B7) is its runtime-flag twin, the
conditional baseline ``KernelBranch`` sets beside it. ``ssd_chunk`` (B8) is
the Mamba-2 SSD chunked scan under the SSM mixer's ``prefill``/``forward``.
``sample_rows`` is every serving step's sampling tail (JAX's threefry
categorical draw and greedy argmax per row, the key split), and
``categorical_rows`` the per-burst engine's sampled step on the same kernel;
it replaces XLA-fused code, not a Pallas kernel. Their wrappers run the
plain version on CPU tensors and launch the kernel on CUDA tensors;
``launches`` on each wrapper counts kernel launches.
"""

from .decode_attention import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_plain,
    paged_decode_attention_plain,
)
from .flash_attention import (
    flash_attention,
    flash_attention_branchy,
    flash_attention_branchy_plain,
    flash_attention_plain,
)
from .ops import KernelBranch
from .prefill_attention import (
    paged_prefill_attention,
    paged_prefill_attention_int8,
    paged_prefill_attention_int8_plain,
    paged_prefill_attention_plain,
)
from .sampling import (
    categorical_rows,
    categorical_rows_plain,
    sample_rows,
    sample_rows_plain,
)
from .ssd_chunk import ssd_chunk, ssd_chunk_plain

KERNELS = (
    paged_decode_attention,
    paged_prefill_attention,
    paged_decode_attention_int8,
    paged_prefill_attention_int8,
    decode_attention,
    flash_attention,
    flash_attention_branchy,
    ssd_chunk,
    sample_rows,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "KernelBranch",
    "categorical_rows",
    "categorical_rows_plain",
    "decode_attention",
    "decode_attention_plain",
    "flash_attention",
    "flash_attention_branchy",
    "flash_attention_branchy_plain",
    "flash_attention_plain",
    "paged_decode_attention",
    "paged_decode_attention_int8",
    "paged_decode_attention_int8_plain",
    "paged_decode_attention_plain",
    "paged_prefill_attention",
    "paged_prefill_attention_int8",
    "paged_prefill_attention_int8_plain",
    "paged_prefill_attention_plain",
    "reset_launch_counts",
    "sample_rows",
    "sample_rows_plain",
    "ssd_chunk",
    "ssd_chunk_plain",
]
