// Attention kernels for Hopper (sm_90a) over a KV cache read one key block
// at a time: chunked prefill (B2, B4) over a pooled KV page cache, in the
// model dtype (B2) or as int8 pages with per-token-row scales (B4), on CUDA
// cores; also the conversions, constants, address policies and launch
// selection the other bodies share (dense decode, B5, runs the cluster-split
// body of paged_decode_split.cuh over DenseRows).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/prefill_attention.py:paged_prefill_attention      (B2)
//   src/repro/kernels/prefill_attention.py:paged_prefill_attention_int8 (B4)
// with the same layouts and the same arithmetic: scores, the online softmax
// (NEG_INF = -2e38, denominator clamped at 1e-37) and the accumulator are
// fp32 whatever the storage type; an int8 K/V element is dequantised as
// float(k) * k_scale[page][t], one fp32 multiply per load, as in the Pallas
// body.
//
// This header holds the templates; paged_attention.cu instantiates the
// model-dtype kernels (B2), paged_attention_int8.cu the int8 ones (B4), so
// each builds as its own nvcc process side by side. flash_attention.cu
// (B6/B7) takes its conversions and constants from here. B2/B4 in bf16 at
// head_dim 64 and 128 run the tensor-core body of paged_prefill_tc.cuh
// instead of paged_prefill_kernel; decode (B1, B3 over PagedRows, B5 over DenseRows in
// decode_attention.cu) runs the cluster-split body of
// paged_decode_split.cuh.
//
// Layouts (pages contiguous):
//   pages        [P, page_size, KH, HD]   float / bfloat16 / int8
//   scales       [P, page_size] float     (int8 pages only)
//   block_tables [B, PB] int32            logical page j of row b -> page id
//   decode:  q/out [B, H, HD],      pos   [B] int32 (row's query position)
//   prefill: q/out [B, C, H, HD],   start [B] int32 (chunk row 0 position)
//   dense:   q/out [B, H, HD], k/v [B, S, KH, HD] by element strides (unit
//            stride on HD), pos a 0-dim int32 read on the device
// Query head h = kh * G + g belongs to kv head kh (G = H / KH, the GQA group).
//
// A block of keys is a page for B1-B4 and kDenseBlock consecutive cache
// rows for B5: the bodies take the block's address from a policy (PagedRows
// chases the block table, DenseRows is the table j -> j), so the online
// softmax of each body is written once.
//
// Semi-static specialisation: the query/output type, the page type,
// head_dim, page_size and the window / softcap modes are template
// parameters, so every specialisation is its own compiled kernel and no tile
// branches on a mode at run time. The host entry points pick the
// instantiation and return cudaErrorInvalidValue for a combination that was
// not instantiated.
//
// What bounds it on the card: each block streams its row's K/V blocks (and,
// for int8, their scales) once from device memory (bytes), and the
// arithmetic per byte is a handful of fp32 FMAs, far below the H100's
// ops:byte balance, so the kernels are memory-bound; int8 pages halve the
// bytes of bf16 ones. The design reads only the blocks a row needs — blocks
// past the row's last query position, and (window mode) blocks wholly before
// its window, are skipped structurally via the loop bounds — and keeps
// scores, softmax state and the accumulator in shared memory, so the only
// device traffic is K/V (+ scales) in, q in and the output out. No tensor
// cores, TMA or wgmma: the simple version that is right first (B2/B4 in bf16
// at head_dim 64 and 128 have a tensor-core body, paged_prefill_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace paged {

constexpr float kNegInf = -2.0e38f;
constexpr float kMinDenom = 1e-37f;
constexpr int kThreads = 128;
constexpr int kPrefillRows = 16;  // packed chunk rows (C*G) per block
constexpr int kDenseBlock = 16;   // dense cache rows per key block (B5)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory tile of one block: TR query rows against one page at a time.
// K and q rows are padded by one float so the score loop (threads over keys)
// hits distinct banks.
template <int HD, int PS, int TR>
struct Tile {
  float q[TR][HD + 1];
  float k[PS][HD + 1];
  float v[PS][HD];
  float s[TR][PS];
  float acc[TR][HD];
  float m[TR];
  float l[TR];
  float corr[TR];
  float ks[PS];  // this page's per-row K/V scales (int8 pages only)
  float vs[PS];
  int qi[TR];  // causal frontier (query position) of each row
};

// Where key block pb of one batch row and kv head lives: element offset of
// its first row, offset of its first scale (int8 pages), valid rows.
struct Block {
  size_t off;
  size_t scale_off;
  int n;
};

// B1-B4: block pb is page table[pb] of a [P, PS, KH, HD] pool.
template <int PS>
struct PagedRows {
  const int* table;
  size_t row_stride;  // KH * HD
  size_t head_off;    // kh * HD
  __device__ Block block(int pb) const {
    const size_t page = static_cast<size_t>(table[pb]);
    return {page * PS * row_stride + head_off, page * PS, PS};
  }
};

// B5: block pb is rows [pb * PS, pb * PS + PS) of one row's dense cache,
// clipped at seq_len (the split body clamps a key to the block's last row).
template <int PS>
struct DenseRows {
  size_t base;        // b * batch_stride + kh * head_stride
  size_t row_stride;  // sequence stride
  int seq_len;
  __device__ Block block(int pb) const {
    return {base + static_cast<size_t>(pb) * PS * row_stride, 0,
            min(PS, seq_len - pb * PS)};
  }
};

// Online-softmax attention of the tile's `rows` query rows (already in
// tile.q / tile.qi) over pages [p_lo, p_hi] of one batch row and kv head,
// addressed by `src` (PagedRows). Leaves the unnormalised accumulator in
// tile.acc and the softmax denominator in tile.l. P is the K/V element
// type; for int8 pages each staged K/V element is multiplied by its row's
// scale.
template <typename P, int HD, int PS, bool WINDOW, bool SOFTCAP, int TR,
          class Rows>
__device__ void attend_pages(Tile<HD, PS, TR>& tile, const P* __restrict__ k,
                             const P* __restrict__ v,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const Rows& src, int rows, int p_lo, int p_hi,
                             float sm_scale, int window, float softcap) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int tid = threadIdx.x;
  for (int i = tid; i < TR * HD; i += kThreads) (&tile.acc[0][0])[i] = 0.f;
  if (tid < TR) {
    tile.m[tid] = kNegInf;
    tile.l[tid] = 0.f;
  }
  for (int pb = p_lo; pb <= p_hi; ++pb) {
    const Block blk = src.block(pb);
    if constexpr (kQuant) {
      if (tid < PS) {
        tile.ks[tid] = k_scale[blk.scale_off + tid];
        tile.vs[tid] = v_scale[blk.scale_off + tid];
      }
      __syncthreads();
    }
    for (int i = tid; i < PS * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const size_t off = blk.off + t * src.row_stride + d;
      if constexpr (kQuant) {
        tile.k[t][d] = to_float(k[off]) * tile.ks[t];
        tile.v[t][d] = to_float(v[off]) * tile.vs[t];
      } else {
        tile.k[t][d] = to_float(k[off]);
        tile.v[t][d] = to_float(v[off]);
      }
    }
    __syncthreads();
    // scores [rows, PS], masked per row: causal, then (window mode) window
    for (int i = tid; i < rows * PS; i += kThreads) {
      const int r = i / PS, t = i % PS;
      float dot = 0.f;
      // 8, not 16: at 16 ptxas spills 4 B in <float, float, 64, 8, no
      // window, softcap>; at 8 no instantiation spills (the sum's order is
      // the loop's either way)
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += tile.q[r][d] * tile.k[t][d];
      float s = dot * sm_scale;
      if constexpr (SOFTCAP) s = tanhf(s / softcap) * softcap;
      const int ki = pb * PS + t;
      bool ok = ki <= tile.qi[r];
      if constexpr (WINDOW) ok = ok && ki > tile.qi[r] - window;
      tile.s[r][t] = ok ? s : kNegInf;
    }
    __syncthreads();
    if (tid < rows) {
      const float m_prev = tile.m[tid];
      float m_new = m_prev;
#pragma unroll
      for (int t = 0; t < PS; ++t) m_new = fmaxf(m_new, tile.s[tid][t]);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < PS; ++t) {
        const float p = expf(tile.s[tid][t] - m_new);
        tile.s[tid][t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      tile.l[tid] = tile.l[tid] * corr + sum;
      tile.m[tid] = m_new;
      tile.corr[tid] = corr;
    }
    __syncthreads();
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      float a = tile.acc[r][d] * tile.corr[r];
#pragma unroll
      for (int t = 0; t < PS; ++t) a += tile.s[r][t] * tile.v[t][d];
      tile.acc[r][d] = a;
    }
    __syncthreads();
  }
}

// B2/B4: one block per (batch row b, kv head kh, tile of kPrefillRows packed
// rows). Packed row r of a kv head is chunk token c = r / G, group member
// g = r % G, query head kh * G + g, causal frontier start + c. The page loop
// runs to the tile's last frontier and (window mode) from its first row's
// window; pages outside that range are masked for every row of the tile.
template <typename T, typename P, int HD, int PS, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                         const P* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ start, T* __restrict__ out,
                         int chunk, int heads, int kv_heads, int pages_per_row,
                         float sm_scale, int window, float softcap) {
  __shared__ Tile<HD, PS, kPrefillRows> tile;
  const int tid = threadIdx.x;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int group = heads / kv_heads;
  const int r0 = blockIdx.z * kPrefillRows;
  const int rows = min(kPrefillRows, chunk * group - r0);
  const int st = start[b];
  // row r of the tile lives at q[b, c, kh*G + g, :]
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = (r0 + i / HD), c = r / group, g = r % group;
    const size_t row = (static_cast<size_t>(b) * chunk + c) * heads +
                       kh * group + g;
    tile.q[i / HD][i % HD] = to_float(q[row * HD + i % HD]);
  }
  if (tid < rows) tile.qi[tid] = st + (r0 + tid) / group;
  const int p_hi = min((st + (r0 + rows - 1) / group) / PS, pages_per_row - 1);
  int p_lo = 0;
  if constexpr (WINDOW) p_lo = max(st + r0 / group - window + 1, 0) / PS;
  __syncthreads();
  const PagedRows<PS> src{block_tables + static_cast<size_t>(b) * pages_per_row,
                          static_cast<size_t>(kv_heads) * HD,
                          static_cast<size_t>(kh) * HD};
  attend_pages<P, HD, PS, WINDOW, SOFTCAP, kPrefillRows>(
      tile, k_pages, v_pages, k_scale, v_scale, src, rows, p_lo, p_hi,
      sm_scale, window, softcap);
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int lr = i / HD, r = r0 + lr, c = r / group, g = r % group;
    const size_t row = (static_cast<size_t>(b) * chunk + c) * heads +
                       kh * group + g;
    out[row * HD + i % HD] =
        from_float<T>(tile.acc[lr][i % HD] / fmaxf(tile.l[lr], kMinDenom));
  }
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;  // nullptr for model-dtype pages
  const float* v_scale;
  const int* block_tables;
  const int* positions;  // pos (decode) or start (prefill)
  void* out;
  int batch, chunk, heads, kv_heads, pages_per_row, window;
  float sm_scale, softcap;
  int splits;  // decode: CTAs a cluster (paged_decode_split.cuh)
};

template <typename T, typename P, int HD, int PS, bool WINDOW, bool SOFTCAP>
struct PrefillLaunch {
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const int rows = a.chunk * (a.heads / a.kv_heads);
    const dim3 grid(a.batch, a.kv_heads,
                    (rows + kPrefillRows - 1) / kPrefillRows);
    paged_prefill_kernel<T, P, HD, PS, WINDOW, SOFTCAP>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const T*>(a.q), static_cast<const P*>(a.k_pages),
            static_cast<const P*>(a.v_pages), a.k_scale, a.v_scale,
            a.block_tables, a.positions, static_cast<T*>(a.out), a.chunk,
            a.heads, a.kv_heads, a.pages_per_row, a.sm_scale, a.window,
            a.softcap);
    return cudaGetLastError();
  }
};

// Host-side selection of the instantiation: mode, then page size.
template <template <typename, typename, int, int, bool, bool> class L,
          typename T, typename P, int HD, int PS>
cudaError_t by_mode(const Args& a, bool window, bool softcap, cudaStream_t s) {
  if (window)
    return softcap ? L<T, P, HD, PS, true, true>::run(a, s)
                   : L<T, P, HD, PS, true, false>::run(a, s);
  return softcap ? L<T, P, HD, PS, false, true>::run(a, s)
                 : L<T, P, HD, PS, false, false>::run(a, s);
}

template <template <typename, typename, int, int, bool, bool> class L,
          typename T, typename P, int HD>
cudaError_t by_page(const Args& a, int page_size, bool window, bool softcap,
                    cudaStream_t s) {
  if (page_size == 8) return by_mode<L, T, P, HD, 8>(a, window, softcap, s);
  if (page_size == 16) return by_mode<L, T, P, HD, 16>(a, window, softcap, s);
  return cudaErrorInvalidValue;
}

// B2/B4 on CUDA cores at one (query type, page type, head_dim): the body for
// fp32 and for head_dim 16 (paged_prefill_tc.cuh serves bf16 at 128).
template <typename T, typename P, int HD>
cudaError_t launch_prefill_cuda_cores(const Args& a, int page_size,
                                      int has_window, int has_softcap,
                                      void* stream) {
  if (a.kv_heads <= 0 || a.heads % a.kv_heads != 0) return cudaErrorInvalidValue;
  return by_page<PrefillLaunch, T, P, HD>(a, page_size, has_window != 0,
                                         has_softcap != 0,
                                         static_cast<cudaStream_t>(stream));
}

}  // namespace paged
