// Paged attention kernels for Hopper (sm_90a): decode (B1) and chunked
// prefill (B2) over a pooled KV page cache.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention.py:paged_decode_attention   (B1)
//   src/repro/kernels/prefill_attention.py:paged_prefill_attention (B2)
// with the same layouts and the same arithmetic: scores, the online softmax
// (NEG_INF = -2e38, denominator clamped at 1e-37) and the accumulator are
// fp32 whatever the storage type.
//
// Layouts (all contiguous):
//   pages        [P, page_size, KH, HD]   float or bfloat16
//   block_tables [B, PB] int32            logical page j of row b -> page id
//   decode:  q/out [B, H, HD],      pos   [B] int32 (row's query position)
//   prefill: q/out [B, C, H, HD],   start [B] int32 (chunk row 0 position)
// Query head h = kh * G + g belongs to kv head kh (G = H / KH, the GQA group).
//
// Semi-static specialisation: the element type, head_dim, page_size and the
// window / softcap modes are template parameters, so every specialisation is
// its own compiled kernel and no tile branches on a mode at run time. The
// host entry points below pick the instantiation and return
// cudaErrorInvalidValue for a combination that was not instantiated.
//
// What bounds it on the card: each block streams its row's K/V pages once
// from device memory (bytes), and the arithmetic per byte is a handful of
// fp32 FMAs, far below the H100's ops:byte balance, so both kernels are
// memory-bound. The design reads only the pages a row needs — pages past the
// row's last query position, and (window mode) pages wholly before its
// window, are skipped structurally via the loop bounds — and keeps scores,
// softmax state and the accumulator in shared memory, so the only device
// traffic is K/V in, q in and the output out. No tensor cores, TMA or wgmma
// yet: this is the simple version that is right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kMinDenom = 1e-37f;
constexpr int kThreads = 128;
constexpr int kDecodeRows = 8;    // query rows (GQA group members) per block
constexpr int kPrefillRows = 16;  // packed chunk rows (C*G) per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
  int qi[TR];  // causal frontier (query position) of each row
};

// Online-softmax attention of the tile's `rows` query rows (already in
// tile.q / tile.qi) over logical pages [p_lo, p_hi] of one batch row, for kv
// head `kh`. Leaves the unnormalised accumulator in tile.acc and the softmax
// denominator in tile.l.
template <typename T, int HD, int PS, bool WINDOW, bool SOFTCAP, int TR>
__device__ void attend_pages(Tile<HD, PS, TR>& tile,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int* __restrict__ table, int kv_heads,
                             int kh, int rows, int p_lo, int p_hi,
                             float sm_scale, int window, float softcap) {
  const int tid = threadIdx.x;
  for (int i = tid; i < TR * HD; i += kThreads) (&tile.acc[0][0])[i] = 0.f;
  if (tid < TR) {
    tile.m[tid] = kNegInf;
    tile.l[tid] = 0.f;
  }
  const size_t row_stride = static_cast<size_t>(kv_heads) * HD;
  for (int pb = p_lo; pb <= p_hi; ++pb) {
    const size_t base = static_cast<size_t>(table[pb]) * PS * row_stride +
                        static_cast<size_t>(kh) * HD;
    for (int i = tid; i < PS * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const size_t off = base + t * row_stride + d;
      tile.k[t][d] = to_float(k_pages[off]);
      tile.v[t][d] = to_float(v_pages[off]);
    }
    __syncthreads();
    // scores [rows, PS], masked per row: causal, then (window mode) window
    for (int i = tid; i < rows * PS; i += kThreads) {
      const int r = i / PS, t = i % PS;
      float dot = 0.f;
#pragma unroll 16
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

// B1: one block per (batch row b, kv head kh, group tile); a group of up to
// kDecodeRows query heads shares one block, so for GQA groups that fit (all
// configs in the repo) it is one block per (b, kh) and each K/V page is read
// once per kv head.
template <typename T, int HD, int PS, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int heads, int kv_heads, int pages_per_row,
                        float sm_scale, int window, float softcap) {
  __shared__ Tile<HD, PS, kDecodeRows> tile;
  const int tid = threadIdx.x;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int group = heads / kv_heads;
  const int h0 = kh * group + blockIdx.z * kDecodeRows;
  const int rows = min(kDecodeRows, group - static_cast<int>(blockIdx.z) *
                                                kDecodeRows);
  const int p = pos[b];
  const T* q_b = q + (static_cast<size_t>(b) * heads + h0) * HD;
  for (int i = tid; i < rows * HD; i += kThreads)
    tile.q[i / HD][i % HD] = to_float(q_b[i]);
  if (tid < rows) tile.qi[tid] = p;
  // structural skips: pages past pos, or (window) wholly before the window
  const int p_hi = min(p / PS, pages_per_row - 1);
  int p_lo = 0;
  if constexpr (WINDOW) p_lo = max(p - window + 1, 0) / PS;
  __syncthreads();
  attend_pages<T, HD, PS, WINDOW, SOFTCAP, kDecodeRows>(
      tile, k_pages, v_pages,
      block_tables + static_cast<size_t>(b) * pages_per_row, kv_heads, kh,
      rows, p_lo, p_hi, sm_scale, window, softcap);
  T* out_b = out + (static_cast<size_t>(b) * heads + h0) * HD;
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD;
    out_b[i] = from_float<T>(tile.acc[r][i % HD] / fmaxf(tile.l[r], kMinDenom));
  }
}

// B2: one block per (batch row b, kv head kh, tile of kPrefillRows packed
// rows). Packed row r of a kv head is chunk token c = r / G, group member
// g = r % G, query head kh * G + g, causal frontier start + c. The page loop
// runs to the tile's last frontier and (window mode) from its first row's
// window; pages outside that range are masked for every row of the tile.
template <typename T, int HD, int PS, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages,
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
  attend_pages<T, HD, PS, WINDOW, SOFTCAP, kPrefillRows>(
      tile, k_pages, v_pages,
      block_tables + static_cast<size_t>(b) * pages_per_row, kv_heads, kh,
      rows, p_lo, p_hi, sm_scale, window, softcap);
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
  const int* block_tables;
  const int* positions;  // pos (decode) or start (prefill)
  void* out;
  int batch, chunk, heads, kv_heads, pages_per_row, window;
  float sm_scale, softcap;
};

template <typename T, int HD, int PS, bool WINDOW, bool SOFTCAP>
struct DecodeLaunch {
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const int group = a.heads / a.kv_heads;
    const dim3 grid(a.batch, a.kv_heads,
                    (group + kDecodeRows - 1) / kDecodeRows);
    paged_decode_kernel<T, HD, PS, WINDOW, SOFTCAP>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
            static_cast<const T*>(a.v_pages), a.block_tables, a.positions,
            static_cast<T*>(a.out), a.heads, a.kv_heads, a.pages_per_row,
            a.sm_scale, a.window, a.softcap);
    return cudaGetLastError();
  }
};

template <typename T, int HD, int PS, bool WINDOW, bool SOFTCAP>
struct PrefillLaunch {
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const int rows = a.chunk * (a.heads / a.kv_heads);
    const dim3 grid(a.batch, a.kv_heads,
                    (rows + kPrefillRows - 1) / kPrefillRows);
    paged_prefill_kernel<T, HD, PS, WINDOW, SOFTCAP>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
            static_cast<const T*>(a.v_pages), a.block_tables, a.positions,
            static_cast<T*>(a.out), a.chunk, a.heads, a.kv_heads,
            a.pages_per_row, a.sm_scale, a.window, a.softcap);
    return cudaGetLastError();
  }
};

// Host-side selection of the instantiation: mode, then shape, then type.
template <template <typename, int, int, bool, bool> class L, typename T,
          int HD, int PS>
cudaError_t by_mode(const Args& a, bool window, bool softcap, cudaStream_t s) {
  if (window)
    return softcap ? L<T, HD, PS, true, true>::run(a, s)
                   : L<T, HD, PS, true, false>::run(a, s);
  return softcap ? L<T, HD, PS, false, true>::run(a, s)
                 : L<T, HD, PS, false, false>::run(a, s);
}

template <template <typename, int, int, bool, bool> class L, typename T>
cudaError_t by_shape(const Args& a, int head_dim, int page_size, bool window,
                     bool softcap, cudaStream_t s) {
  if (head_dim == 16 && page_size == 8)
    return by_mode<L, T, 16, 8>(a, window, softcap, s);
  if (head_dim == 16 && page_size == 16)
    return by_mode<L, T, 16, 16>(a, window, softcap, s);
  if (head_dim == 128 && page_size == 8)
    return by_mode<L, T, 128, 8>(a, window, softcap, s);
  if (head_dim == 128 && page_size == 16)
    return by_mode<L, T, 128, 16>(a, window, softcap, s);
  return cudaErrorInvalidValue;
}

template <template <typename, int, int, bool, bool> class L>
int launch(const Args& a, int dtype, int head_dim, int page_size,
           int has_window, int has_softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.heads % a.kv_heads != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return by_shape<L, float>(a, head_dim, page_size, has_window != 0,
                              has_softcap != 0, s);
  if (dtype == 1)
    return by_shape<L, __nv_bfloat16>(a, head_dim, page_size, has_window != 0,
                                      has_softcap != 0, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success). Launches on `stream`, allocates nothing, does not sync.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* pos, void* out, int batch,
    int heads, int kv_heads, int pages_per_row, int dtype, int head_dim,
    int page_size, int has_window, int window, int has_softcap,
    float softcap, float sm_scale, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const int*>(block_tables),
               static_cast<const int*>(pos), out, batch, 1, heads, kv_heads,
               pages_per_row, window, sm_scale, softcap};
  return launch<DecodeLaunch>(a, dtype, head_dim, page_size, has_window,
                              has_softcap, stream);
}

extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* start, void* out, int batch,
    int chunk, int heads, int kv_heads, int pages_per_row, int dtype,
    int head_dim, int page_size, int has_window, int window, int has_softcap,
    float softcap, float sm_scale, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const int*>(block_tables),
               static_cast<const int*>(start), out, batch, chunk, heads,
               kv_heads, pages_per_row, window, sm_scale, softcap};
  return launch<PrefillLaunch>(a, dtype, head_dim, page_size, has_window,
                               has_softcap, stream);
}
