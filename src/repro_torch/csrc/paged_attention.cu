// Paged decode (B1) and chunked prefill (B2) attention over model-dtype
// pages: the host entry points of the templates in paged_attention.cuh,
// instantiated for q/pages in {float32, bfloat16}.
#include "paged_attention.cuh"

using paged::Args;

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out). Returns the
// cudaError_t of the launch (0 on success). Launches on `stream`, allocates
// nothing, does not sync.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* pos, void* out, int batch,
    int heads, int kv_heads, int pages_per_row, int dtype, int head_dim,
    int page_size, int has_window, int window, int has_softcap,
    float softcap, float sm_scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(pos), out, batch, 1, heads, kv_heads,
               pages_per_row, window, sm_scale, softcap};
  return paged::launch<paged::DecodeLaunch, false>(
      a, dtype, head_dim, page_size, has_window, has_softcap, stream);
}

extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* start, void* out, int batch,
    int chunk, int heads, int kv_heads, int pages_per_row, int dtype,
    int head_dim, int page_size, int has_window, int window, int has_softcap,
    float softcap, float sm_scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(start), out, batch, chunk, heads,
               kv_heads, pages_per_row, window, sm_scale, softcap};
  return paged::launch<paged::PrefillLaunch, false>(
      a, dtype, head_dim, page_size, has_window, has_softcap, stream);
}
