// Paged decode (B3) and chunked prefill (B4) attention over int8 pages with
// f32 per-token-row scales: the host entry points of the templates,
// instantiated for q/out in {float32, bfloat16}. B3 runs the cluster-split
// body of paged_decode_split.cuh. B4 is also the verify lane's kernel (a
// chunk of K+1 rows); in bf16 at head_dim 64 and 128 it runs the
// tensor-core body of paged_prefill_tc.cuh, the rest paged_attention.cuh's
// CUDA cores.
#include "paged_attention.cuh"
#include "paged_decode_split.cuh"
#include "paged_prefill_tc.cuh"

using paged::Args;
using paged::launch_prefill_cuda_cores;
using paged_split::launch_decode_split;
using paged_tc::launch_prefill_tensor_cores;

// dtype: 0 = float32, 1 = bfloat16 (q and out); head_dim 16, 64 or 128;
// pages are int8 and k_scale / v_scale are float32 [P, page_size]; splits as in
// paged_decode_attention. Returns the cudaError_t of the launch (0 on
// success). Launches on `stream`, allocates nothing, does not sync.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, void* out, int batch, int heads, int kv_heads,
    int pages_per_row, int splits, int dtype, int head_dim, int page_size,
    int has_window, int window, int has_softcap, float softcap,
    float sm_scale, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(pos), out, batch, 1, heads, kv_heads,
               pages_per_row, window, sm_scale, softcap, splits};
  const int w = has_window, c = has_softcap;
  if (dtype == 0 && head_dim == 16) return launch_decode_split<float, int8_t, 16>(a, page_size, w, c, stream);
  if (dtype == 0 && head_dim == 64) return launch_decode_split<float, int8_t, 64>(a, page_size, w, c, stream);
  if (dtype == 0 && head_dim == 128) return launch_decode_split<float, int8_t, 128>(a, page_size, w, c, stream);
  if (dtype == 1 && head_dim == 16) return launch_decode_split<__nv_bfloat16, int8_t, 16>(a, page_size, w, c, stream);
  if (dtype == 1 && head_dim == 64) return launch_decode_split<__nv_bfloat16, int8_t, 64>(a, page_size, w, c, stream);
  if (dtype == 1 && head_dim == 128) return launch_decode_split<__nv_bfloat16, int8_t, 128>(a, page_size, w, c, stream);
  return cudaErrorInvalidValue;
}

// As paged_decode_attention_int8, with the chunk length after batch and the
// pool's page count (for its tensor maps) after pages_per_row.
extern "C" int paged_prefill_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* start, void* out, int batch, int chunk, int heads,
    int kv_heads, int pages_per_row, int num_pages, int dtype, int head_dim,
    int page_size, int has_window, int window, int has_softcap, float softcap,
    float sm_scale, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(start), out, batch, chunk, heads,
               kv_heads, pages_per_row, window, sm_scale, softcap};
  const int w = has_window, c = has_softcap;
  if (dtype == 1 && head_dim == 64) return launch_prefill_tensor_cores<int8_t, 64>(a, num_pages, page_size, w, c, stream);
  if (dtype == 1 && head_dim == 128) return launch_prefill_tensor_cores<int8_t, 128>(a, num_pages, page_size, w, c, stream);
  if (dtype == 0 && head_dim == 16) return launch_prefill_cuda_cores<float, int8_t, 16>(a, page_size, w, c, stream);
  if (dtype == 0 && head_dim == 64) return launch_prefill_cuda_cores<float, int8_t, 64>(a, page_size, w, c, stream);
  if (dtype == 0 && head_dim == 128) return launch_prefill_cuda_cores<float, int8_t, 128>(a, page_size, w, c, stream);
  if (dtype == 1 && head_dim == 16) return launch_prefill_cuda_cores<__nv_bfloat16, int8_t, 16>(a, page_size, w, c, stream);
  return cudaErrorInvalidValue;
}
