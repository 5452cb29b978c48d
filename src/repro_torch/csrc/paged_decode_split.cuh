// Paged single-token decode attention split over a thread-block cluster
// ("flash-decoding"): B1 over model-dtype pages (paged_attention.cu) and B3
// over int8 pages with f32 per-token-row scales (paged_attention_int8.cu),
// at every query type, head_dim, page size and window / softcap mode.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention.py:paged_decode_attention        (B1)
//   src/repro/kernels/decode_attention.py:paged_decode_attention_int8   (B3)
// One query token per batch row; its GQA group [G, HD] of kv head kh attends
// over the row's pages with the causal mask ki <= pos[b], an optional
// sliding window and logit softcap. Scores, softmax and accumulators are
// fp32 (NEG_INF -2e38, denominator clamped at 1e-37); only the output is
// rounded to q's type.
//
// What bounds it on the card: the K/V bytes of the row's visible pages
// (memory; int8 pages halve them) at a few FMAs a byte. At the serving
// shapes (8 rows x 16 kv heads of 128, 7-16 pages of 16) that is ~10 MB, a
// few microseconds of HBM, so what decides is how many loads are in flight
// and how long the chains behind them are. The design:
//   - grid (B, KH, tiles x S) in clusters of (1, 1, S): the S CTAs of one
//     (row, kv head, group tile) split the row's needed pages [p_lo, p_hi]
//     (p_hi from pos, p_lo from the window) into S contiguous shares by
//     cluster rank, so a short row and a long one both spread over all S.
//     S (1-8, the portable cluster size) is a launch argument the wrapper
//     picks from static shapes; z = tile * S + rank;
//   - no shared-memory staging of K/V: kWarps warps take disjoint keys of
//     the CTA's share; each lane loads its 16-byte slice of a key row
//     straight from global memory (kLanes lanes a row), kUnroll rows of K
//     and of V at once, before the first dot product is reduced by
//     shuffles. q sits in fp32 registers. Each lane group keeps its own
//     online softmax (m, l, acc) in registers; a masked key weighs exactly 0,
//     so a partial that saw only masked keys (or none) is m = NEG_INF,
//     l = 0, acc = 0;
//   - int8 pages: each key's dot product is scaled by its k_scale, and p by
//     its v_scale before P V; all in fp32, so the result equals the plain
//     version's up to summation order;
//   - partials merge in one form at every level (lane groups by shuffles,
//     warps in shared memory, then the cluster): m = max m_s, weights
//     exp(m_s - m), l = sum w_s l_s, acc = sum w_s acc_s. The row's m is
//     finite (key pos is always visible), so an empty partial weighs 0.
//     After cluster.sync() rank 0 reads the other CTAs' partials through
//     distributed shared memory (map_shared_rank) and writes acc / l; a
//     second cluster.sync() keeps their shared memory alive until it has. A
//     CTA whose share is empty (a row of fewer pages than S) still reaches
//     both syncs: the body has no early return;
//   - one launch per call: no scratch in device memory, no atomics, no
//     allocation, no sync with the host.
// A group tile holds R query rows: R = 1 for G = 1 (MHA, the served model)
// and kTileRows otherwise. q's and acc's registers grow with R times a
// lane's slice, so one R for all groups would cost MHA its occupancy.
//
// The body (decode_split) reads keys through an address policy (PagedRows
// chases the block table; paged_attention.cuh's DenseRows is the table
// j -> j), so a dense cache can take the same body.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "paged_attention.cuh"

namespace paged_split {

namespace cg = cooperative_groups;
using paged::Args;
using paged::Block;
using paged::kMinDenom;
using paged::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kTileRows = 4;   // query rows a CTA holds when G > 1
constexpr unsigned kFull = 0xffffffffu;

// How a warp covers key rows of page type P at head_dim HD: a lane loads 16
// bytes (kVec elements) of a row, kLanes lanes cover a row, so one
// warp-wide load covers kKeys rows; kUnroll such loads of K and of V are in
// flight per lane, kStep keys a warp iteration.
template <typename P, int HD>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(P));
  static constexpr int kLanes = HD / kVec;
  static constexpr int kKeys = 32 / kLanes;
  static constexpr int kUnroll = kKeys >= 8 ? 1 : (kKeys >= 4 ? 2 : 4);
  static constexpr int kStep = kUnroll * kKeys;
  static_assert(HD % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "a key row must cover a power-of-two share of a warp");
};

// The kVec values of one 16-byte load as fp32 (bf16 and int8 exactly).
template <typename P>
__device__ __forceinline__ void widen(const uint4& raw,
                                      float (&x)[16 / sizeof(P)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<P, float>::value) {
      x[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
    }
  }
}

// Sum over the N lanes of an aligned lane group (N a power of two).
template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = N / 2; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// One CTA's shared memory: each warp's partial, then the CTA's.
template <int HD, int R>
struct Partials {
  float acc[kWarps][R][HD];
  float m[kWarps][R];
  float l[kWarps][R];
  float cta_acc[R][HD];
  float cta_m[R];
  float cta_l[R];
};

// The body: `rows` query rows (q / out rows `q_stride` / `out_stride`
// elements apart, all at position qpos) against key blocks [p_lo, p_hi] of
// one (row, kv head), addressed by `src`, split over the calling cluster.
template <typename T, typename P, int HD, int PS, bool WINDOW, bool SOFTCAP,
          int R, class Rows>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, size_t q_stride, T* __restrict__ out,
    size_t out_stride, int rows, const P* __restrict__ k,
    const P* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& src, int p_lo, int p_hi,
    int qpos, float sm_scale, int window, float softcap) {
  using L = Layout<P, HD>;
  constexpr int E = L::kVec, U = L::kUnroll;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  __shared__ Partials<HD, R> part;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane % L::kLanes * E;

  float qf[R][E], m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[r][e] = r < rows ? paged::to_float(q[r * q_stride + d0 + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  }
  // this CTA's share of the needed blocks, by cluster rank (maybe empty)
  const int n = max(p_hi - p_lo + 1, 0);
  const int k_begin = (p_lo + rank * n / splits) * PS;
  const int k_end = (p_lo + (rank + 1) * n / splits) * PS;

  for (int base = k_begin + warp * L::kStep; base < k_end;
       base += kWarps * L::kStep) {
    // every load of the iteration first; keys past the share re-read its
    // last row (in bounds, L1-hot) and are masked
    uint4 kr[U], vr[U];
    float ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * L::kKeys + lane / L::kLanes;
      ok[u] = key < k_end && key <= qpos;
      if constexpr (WINDOW) ok[u] = ok[u] && key > qpos - window;
      const int kc = min(key, k_end - 1);
      const Block blk = src.block(kc / PS);
      const int t = min(kc % PS, blk.n - 1);
      const size_t off = blk.off + static_cast<size_t>(t) * src.row_stride + d0;
      kr[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
      vr[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
      if constexpr (kQuant) {
        ks[u] = __ldg(k_scale + blk.scale_off + t);
        vs[u] = __ldg(v_scale + blk.scale_off + t);
      }
    }
    float s[R][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
      widen<P>(kr[u], x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[r][e], x[e], dot);
          dot = group_sum<L::kLanes>(dot);
          if constexpr (kQuant) dot *= ks[u];
          float sc = dot * sm_scale;
          if constexpr (SOFTCAP) sc = tanhf(sc / softcap) * softcap;
          s[r][u] = ok[u] ? sc : kNegInf;
        }
      }
    }
    // online softmax of each row; s becomes the weight of each V row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        float mn = m[r];
#pragma unroll
        for (int u = 0; u < U; ++u) mn = fmaxf(mn, s[r][u]);
        const float corr = expf(m[r] - mn);
        m[r] = mn;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = ok[u] ? expf(s[r][u] - mn) : 0.f;
          l[r] += p;
          s[r][u] = kQuant ? p * vs[u] : p;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
      widen<P>(vr[u], x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(s[r][u], x[e], acc[r][e]);
        }
      }
    }
  }

  // merge the warp's lane groups (each then holds the warp's partial)
#pragma unroll
  for (int off = L::kLanes; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const float mb = __shfl_xor_sync(kFull, m[r], off);
        const float lb = __shfl_xor_sync(kFull, l[r], off);
        const float mn = fmaxf(m[r], mb);
        const float wa = expf(m[r] - mn), wb = expf(mb - mn);
        m[r] = mn;
        l[r] = l[r] * wa + lb * wb;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = acc[r][e] * wa + __shfl_xor_sync(kFull, acc[r][e], off) * wb;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      if (lane < L::kLanes) {
#pragma unroll
        for (int e = 0; e < E; ++e) part.acc[warp][r][d0 + e] = acc[r][e];
      }
      if (lane == 0) {
        part.m[warp][r] = m[r];
        part.l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  // merge the warps into the CTA's partial
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part.m[w][r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(part.m[w][r] - mx);
      a += wt * part.acc[w][r][d];
      ls += wt * part.l[w][r];
    }
    part.cta_acc[r][d] = a;
    if (d == 0) {
      part.cta_m[r] = mx;
      part.cta_l[r] = ls;
    }
  }
  cluster.sync();  // every CTA's partial is written and visible
  if (rank == 0) {
    for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      float ms[kMaxSplits];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kMaxSplits; ++c) {
        if (c < splits) {
          ms[c] = *cluster.map_shared_rank(&part.cta_m[r], c);
          mx = fmaxf(mx, ms[c]);
        }
      }
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxSplits; ++c) {
        if (c < splits) {
          const float wt = expf(ms[c] - mx);
          a += wt * *cluster.map_shared_rank(&part.cta_acc[r][d], c);
          ls += wt * *cluster.map_shared_rank(&part.cta_l[r], c);
        }
      }
      out[r * out_stride + d] = paged::from_float<T>(a / fmaxf(ls, kMinDenom));
    }
  }
  cluster.sync();  // the other CTAs' shared memory outlives rank 0's reads
}

// B1/B3: one cluster of S CTAs per (batch row b, kv head kh, group tile of
// R query heads); blockIdx.z = tile * S + cluster rank.
template <typename T, typename P, int HD, int PS, bool WINDOW, bool SOFTCAP,
          int R>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ pos, T* __restrict__ out, int heads, int kv_heads,
    int pages_per_row, float sm_scale, int window, float softcap) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int tile = blockIdx.z / static_cast<int>(cg::this_cluster().num_blocks());
  const int group = heads / kv_heads;
  const int rows = min(R, group - tile * R);
  const size_t row0 = (static_cast<size_t>(b) * heads + kh * group + tile * R) * HD;
  const int p = pos[b];
  // structural skips: blocks past pos, or (window) wholly before the window
  const int p_hi = min(p / PS, pages_per_row - 1);
  int p_lo = 0;
  if constexpr (WINDOW) p_lo = max(p - window + 1, 0) / PS;
  const paged::PagedRows<PS> src{
      block_tables + static_cast<size_t>(b) * pages_per_row,
      static_cast<size_t>(kv_heads) * HD, static_cast<size_t>(kh) * HD};
  decode_split<T, P, HD, PS, WINDOW, SOFTCAP, R>(
      q + row0, HD, out + row0, HD, rows, k_pages, v_pages, k_scale, v_scale,
      src, p_lo, p_hi, p, sm_scale, window, softcap);
}

// Launch `kernel` on a (batch, kv heads, tiles x splits) grid in clusters
// of (1, 1, splits), kThreads a CTA; the launch's own error comes back (a
// cluster the card refuses included). B1/B3 and B5 launch through it.
template <typename... Params, typename... Values>
cudaError_t launch_split(void (*kernel)(Params...), int batch, int kv_heads,
                         int tiles, int splits, cudaStream_t stream,
                         Values&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, kv_heads, tiles * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Values>(args)...);
}

template <typename T, typename P, int HD, int PS, bool WINDOW, bool SOFTCAP>
struct SplitLaunch {
  template <int R>
  static cudaError_t launch(const Args& a, cudaStream_t stream) {
    const int tiles = (a.heads / a.kv_heads + R - 1) / R;
    return launch_split(
        paged_decode_split_kernel<T, P, HD, PS, WINDOW, SOFTCAP, R>, a.batch,
        a.kv_heads, tiles, a.splits, stream,
        static_cast<const T*>(a.q), static_cast<const P*>(a.k_pages),
        static_cast<const P*>(a.v_pages), a.k_scale, a.v_scale,
        a.block_tables, a.positions, static_cast<T*>(a.out), a.heads,
        a.kv_heads, a.pages_per_row, a.sm_scale, a.window, a.softcap);
  }
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    return a.heads == a.kv_heads ? launch<1>(a, stream)
                                 : launch<kTileRows>(a, stream);
  }
};

// B1/B3 at one (query type, page type, head_dim): a.splits CTAs a cluster,
// cudaErrorInvalidValue outside 1-kMaxSplits; the launch's own error
// otherwise (a cluster the card refuses comes back from cudaLaunchKernelEx).
template <typename T, typename P, int HD>
cudaError_t launch_decode_split(const Args& a, int page_size, int has_window,
                                int has_softcap, void* stream) {
  if (a.kv_heads <= 0 || a.heads % a.kv_heads != 0 || a.splits < 1 ||
      a.splits > kMaxSplits)
    return cudaErrorInvalidValue;
  return paged::by_page<SplitLaunch, T, P, HD>(
      a, page_size, has_window != 0, has_softcap != 0,
      static_cast<cudaStream_t>(stream));
}

}  // namespace paged_split
