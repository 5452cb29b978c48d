// Chunked prefill attention over a paged KV cache on Hopper's tensor cores:
// B2 (bf16 pages, paged_attention.cu) and B4 (int8 pages with f32
// per-token-row scales, paged_attention_int8.cu) for a bf16 query at
// head_dim HD = 64 or 128 (a template parameter). The C entry points route
// bf16 at head_dim 64 and 128 here and fp32 or head_dim 16 to
// paged_attention.cuh's CUDA-core body (wgmma has no fp32 mode but TF32,
// which would break the fp32 1e-4 tolerance).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/prefill_attention.py:paged_prefill_attention      (B2)
//   src/repro/kernels/prefill_attention.py:paged_prefill_attention_int8 (B4)
// (and their verify-lane aliases: a chunk of K+1 rows). A chunk of C query
// tokens per batch row attends over the row's pages, which already hold the
// chunk's own K/V; packed row r of kv head kh is chunk token r / G, query
// head kh * G + r % G, causal at start[b] + r / G, with an optional sliding
// window and logit softcap.
//
// What bounds it on the card: at the serving shapes (8 rows x 64 tokens over
// up to 256 keys, 16 kv heads) a block reads a few pages per kv head, so the
// K/V bytes and the latency of their loads dominate; the products are small.
// The CUDA-core body walked one page at a time, each a synchronous load
// staged in fp32, 4-5 __syncthreads and a softmax run by 16 of 128 threads,
// and served only 16 packed rows a block (every page read by 4 blocks).
// This body:
//   - one block per (batch row, kv head, tile of 64 packed rows) of 160
//     threads: one consumer warpgroup (the 64-row wgmma M tile; rows past
//     C*G are computed on zero queries and never stored) and one producer
//     warp;
//   - the producer reads block_tables[b] and keeps key tiles of 64 keys in
//     flight, kStages ahead: each page of a tile is one TMA box of a 4-D map
//     of the pool [P, PS, KH, HD] (dims HD, KH, PS, P): (64, 1, PS, 1) per
//     64-wide head_dim half for bf16 (two halves at 128, one at 64), landing
//     as PS rows of 128 bytes in the 128-byte swizzle, so 64 / PS boxes
//     stack into the [64 keys][64] halves wgmma reads (K-major for
//     S = Q K^T, MN-major for P V); (HD, 1, PS, 1) unswizzled for int8.
//     Full (bytes) and empty (consumer) mbarriers guard each stage. Pages
//     of an edge tile outside [p_lo, p_hi] re-read a page inside it
//     (finite data, L2-hot) and are masked;
//   - Q is loaded once: by TMA when G divides 64 (a box (64, G, 64 / G, 1)
//     of q [B, C, H, HD] per half lands in packed-row order), else by the
//     consumers with 16-byte loads into the same swizzled layout (G = 5);
//   - S = Q K^T by wgmma m64n64k16 from shared memory (HD / 16 k-steps),
//     the online softmax in registers (ex2.approx of logits scaled by
//     log2 e, tanh.approx.f32 for the softcap with its reciprocal hoisted),
//     P rounded to bf16 in registers as the A operand of O += P V (wgmma
//     m64nHDk16: n128 at 128, n64 at 64; V MN-major),
//     O and (m, l) in fp32 registers, NEG_INF -2e38, denominator clamped at
//     1e-37, out = O / l rounded to bf16;
//   - key tiles past the tile's last frontier, and (window) tiles wholly
//     before its first row's window, are never loaded (the loop bounds);
//     only edge tiles test elements, against a per-row column range.
// int8 pages (B4) without a second rounding: values in [-127, 127] are exact
// in bf16, so the consumer warpgroup itself widens each landed int8 K and V
// tile to bf16 in shared memory (16-byte stores into the swizzled layouts),
// while the producer's TMA loads of the next stages stay in flight; the K
// scale k_scale[page][t] multiplies S's column t in fp32 after Q K^T, and
// the V scale multiplies P's column t before P is rounded to bf16 while l
// sums the unscaled p: sum_t p (v vs) / l, the dequantisation adding no
// rounding beyond the P rounding B6 has. Each row's scales enter P relative
// to the scale of its leading key in the tile, which multiplies O's row in
// fp32 after P V, so that key's weight rounds as in B2. The scales ([P, PS]
// f32) come in beside their tile by bulk copies on the K barrier, and the
// stage is released once its V is widened.
//
// Window, softcap, page size and the page type are template parameters; no
// tile branches on a mode. The host side caches each pool's tensor map by
// (pointer, shape) and encodes q's per call (host work only, nothing sent
// to the card); each instantiation opts into its dynamic shared memory
// once. The entry points return cudaGetLastError() and do not sync.
#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "flash_tc.cuh"
#include "paged_attention.cuh"

namespace paged_tc {

using paged::kMinDenom;
using paged::kNegInf;

constexpr int kRows = 64;                      // packed query rows per block
constexpr int kKeys = 64;                      // keys per tile
constexpr int kStages = 4;                     // K/V ring depth
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr int kQHalf = kRows * 128;            // [64 rows][64] bf16: 8 KB
constexpr int kKvHalf = kKeys * 128;           // [64 keys][64] bf16: 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kConsumerBar = 1;           // named barrier of the consumers

// Byte offsets in dynamic shared memory (from a 1024-aligned base) for
// pages of type P at head_dim HD (HD / 64 swizzled halves a bf16 tile).
template <typename P, int HD>
struct Layout {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kHalves = HD / 64;
  static constexpr int kTile = kKeys * HD * static_cast<int>(sizeof(P));
  static constexpr int kBf16Tile = kHalves * kKvHalf;  // [64 keys][HD] bf16
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kHalves * kQHalf;  // K stages
  static constexpr int kV = kK + kStages * kTile;   // V stages
  static constexpr int kWide = kV + kStages * kTile;  // int8: bf16 K, V
  static constexpr int kScales = kWide + (kQuant ? 2 * kBf16Tile : 0);
  // int8: per stage the K then the V scales of its 64 keys
  static constexpr int kBars =
      kScales + (kQuant ? kStages * 2 * kKeys * 4 : 0);
  // q_full, k_full[S], v_full[S], empty[S], and slack to align the base
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

struct TcArgs {
  const __nv_bfloat16* q;  // [B, C, H, HD] (the consumers' loads of Q)
  const float* k_scale;    // [P, PS] (int8 pages only)
  const float* v_scale;
  const int* block_tables;
  const int* start;
  __nv_bfloat16* out;
  int chunk, heads, kv_heads, pages_per_row, window;
  float sm_scale, softcap;
};

// int8 [64 keys][HD] (unswizzled) -> bf16 [HD / 64 halves][64 keys][64] in
// the 128-byte swizzle, by the 128 consumer threads: 8 bytes in, 16 out each.
template <int HD>
__device__ __forceinline__ void widen(const uint8_t* src, uint8_t* dst) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kKeys * HD / 8 / kConsumers; ++j) {
    const int i = tid + j * kConsumers;  // 8-byte chunk of the tile
    const int row = i / (HD / 8), c16 = i % (HD / 8);
    const uint2 w = *reinterpret_cast<const uint2*>(src + row * HD + c16 * 8);
    const int8_t* v = reinterpret_cast<const int8_t*>(&w);
    uint4 o;
    o.x = flash_tc::pack_bf16(static_cast<float>(v[0]), static_cast<float>(v[1]));
    o.y = flash_tc::pack_bf16(static_cast<float>(v[2]), static_cast<float>(v[3]));
    o.z = flash_tc::pack_bf16(static_cast<float>(v[4]), static_cast<float>(v[5]));
    o.w = flash_tc::pack_bf16(static_cast<float>(v[6]), static_cast<float>(v[7]));
    *reinterpret_cast<uint4*>(dst + (c16 / 8) * kKvHalf + row * 128 +
                              (((c16 % 8) ^ (row % 8)) << 4)) = o;
  }
}

template <typename P, int HD, int PS, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    paged_prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const TcArgs a, const int q_by_tma) {
  using namespace flash_tc;
  using L = Layout<P, HD>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kHalves = L::kHalves;
  constexpr int kBf16Tile = L::kBf16Tile;
  // a page's rows in a tile: 128-byte half rows (bf16), HD-byte rows (int8)
  constexpr int kRowBytes = kQuant ? HD : 128;
  constexpr int kPages = kKeys / PS;  // pages per key tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t base = smem_addr(smem);
  const uint32_t s_q = base + L::kQ;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  float* scales = reinterpret_cast<float*>(smem + L::kScales);

  const int b = blockIdx.x, kh = blockIdx.y;
  const int group = a.heads / a.kv_heads;
  const int rows = a.chunk * group;  // packed rows of this kv head
  const int r_first = blockIdx.z * kRows;
  const int r_last = min(r_first + kRows, rows) - 1;
  const int st = a.start[b];
  const int f_first = st + r_first / group;  // causal frontiers of the
  const int f_last = st + r_last / group;    // tile's first and last rows
  const int p_hi = min(f_last / PS, a.pages_per_row - 1);
  int p_lo = 0;
  if constexpr (WINDOW) p_lo = max(f_first - a.window + 1, 0) / PS;
  const int t_lo = p_lo * PS / kKeys;
  const int n_tiles = p_hi >= p_lo ? p_hi * PS / kKeys - t_lo + 1 : 0;
  const int key_end = (p_hi + 1) * PS - 1;  // last key the table holds
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer warp: one thread issues copies
    if (lane == 0) {
      if (q_by_tma) {
        const int c0 = r_first / group;
        mbar_expect_tx(q_full, kHalves * kQHalf);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
          tma_load_4d(s_q + hf * kQHalf, &tq, q_full, 64 * hf, kh * group, c0,
                      b);
      }
      const int* table = a.block_tables + static_cast<size_t>(b) * a.pages_per_row;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        int page[kPages];
#pragma unroll
        for (int i = 0; i < kPages; ++i)
          page[i] = __ldg(table + min(max((t_lo + j) * kPages + i, p_lo), p_hi));
        if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
        const uint32_t kd = base + L::kK + s * L::kTile;
        const uint32_t vd = base + L::kV + s * L::kTile;
        mbar_expect_tx(k_full(s), L::kTile + (kQuant ? 2 * kKeys * 4 : 0));
#pragma unroll
        for (int i = 0; i < kPages; ++i) {
          tma_load_4d(kd + i * PS * kRowBytes, &tk, k_full(s), 0, kh, 0,
                      page[i]);
          if constexpr (kQuant) {
            const uint32_t sd = smem_addr(scales + s * 2 * kKeys + i * PS);
            bulk_load(sd, a.k_scale + static_cast<size_t>(page[i]) * PS,
                      PS * 4, k_full(s));
            bulk_load(sd + kKeys * 4, a.v_scale + static_cast<size_t>(page[i]) * PS,
                      PS * 4, k_full(s));
          } else if constexpr (kHalves == 2) {
            tma_load_4d(kd + kKvHalf + i * PS * 128, &tk, k_full(s), 64, kh,
                        0, page[i]);
          }
        }
        mbar_expect_tx(v_full(s), L::kTile);
#pragma unroll
        for (int i = 0; i < kPages; ++i) {
          tma_load_4d(vd + i * PS * kRowBytes, &tv, v_full(s), 0, kh, 0,
                      page[i]);
          if constexpr (!kQuant && kHalves == 2)
            tma_load_4d(vd + kKvHalf + i * PS * 128, &tv, v_full(s), 64, kh,
                        0, page[i]);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds packed rows R0 and R1 = R0 + 8,
  // columns 8 i + 2 t (+1) of each fragment
  const int g = lane / 4, t = lane % 4;
  const int R0 = r_first + 16 * warp + g, R1 = R0 + 8;
  const int qi0 = st + R0 / group, qi1 = st + R1 / group;
  if (!q_by_tma) {
    // 16-byte loads of q rows into the swizzled layout; rows past C*G zero
    for (int i = threadIdx.x; i < kRows * HD / 8; i += kConsumers) {
      const int r = i / (HD / 8), c16 = i % (HD / 8), R = r_first + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (R < rows) {
        const size_t row = (static_cast<size_t>(b) * a.chunk + R / group) *
                               a.heads + kh * group + R % group;
        val = *reinterpret_cast<const uint4*>(a.q + row * HD + c16 * 8);
      }
      *reinterpret_cast<uint4*>(smem + L::kQ + (c16 / 8) * kQHalf + r * 128 +
                                (((c16 % 8) ^ (r % 8)) << 4)) = val;
    }
    fence_proxy_async();
    named_sync(kConsumerBar, kConsumers);
  } else {
    mbar_wait(q_full, 0);
  }

  // O: columns 8 i + 2 t (+1) of rows R0 (o[4 i], o[4 i + 1]) and R1
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[32];
  uint32_t pa[16];
  float inv_cap = 0.f;
  if constexpr (SOFTCAP) inv_cap = 1.f / a.softcap;
  // each row's visible keys, less 2 t: causal and the table's end from
  // above, the window from below
  const int hi0 = min(qi0, key_end) - 2 * t, hi1 = min(qi1, key_end) - 2 * t;
  const int lo0 = qi0 - a.window + 1 - 2 * t, lo1 = qi1 - a.window + 1 - 2 * t;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, k0 = (t_lo + j) * kKeys;
    const uint32_t phase = (j / kStages) & 1;
    uint32_t kt = base + L::kK + s * L::kTile;
    uint32_t vt = base + L::kV + s * L::kTile;

    mbar_wait(k_full(s), phase);
    if constexpr (kQuant) {
      widen<HD>(smem + L::kK + s * L::kTile, smem + L::kWide);
      fence_proxy_async();
      named_sync(kConsumerBar, kConsumers);
      kt = base + L::kWide;
      vt = base + L::kWide + kBf16Tile;
    }
    // S = Q K^T: HD / 16 k-steps of 16 over head_dim, 4 in each 64-wide half
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss(sc, sw128_desc(s_q + (kk / 4) * kQHalf + (kk % 4) * 32, 16, 1024),
               sw128_desc(kt + (kk / 4) * kKvHalf + (kk % 4) * 32, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // logits in the log2 domain; the element test only on edge tiles
    bool edge = k0 + kKeys - 1 > min(f_first, key_end);
    if constexpr (WINDOW) edge = edge || k0 <= f_last - a.window;
    const float* ks = scales + s * 2 * kKeys + 2 * t;
    const float* vs = ks + kKeys;
    const int last0 = hi0 - k0, last1 = hi1 - k0;  // per-row column range
    const int first0 = lo0 - k0, first1 = lo1 - k0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + (i & 1);  // column - k0 - 2 t
      float x = sc[i] * a.sm_scale;
      if constexpr (kQuant) x *= ks[c];
      if constexpr (SOFTCAP) x = tanh_approx(x * inv_cap) * a.softcap;
      bool hidden = c > ((i & 2) ? last1 : last0);
      if constexpr (WINDOW) hidden = hidden || c < ((i & 2) ? first1 : first0);
      sc[i] = edge && hidden ? kNegInf : x * kLog2e;
    }

    // online softmax over the quad that shares a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float c0 = exp2_approx(m0 - mx0), c1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // int8: each row's V scales fold into P relative to the scale of the
    // row's leading key in the tile (S), which multiplies O's row in fp32
    // after P V; that key's weight then rounds as B2's does (p = 1 exactly
    // at the running max), where folding the bare scale would round it
    // too: the one key a chunk's first rows see carries |o| up to ~4.
    float lead0 = 1.f, lead1 = 1.f;  // S of rows R0, R1
    if constexpr (kQuant) {
      float top0 = kNegInf, top1 = kNegInf;
      auto lead = [](float& top, float& sv, float x, float v) {
        if (x > top || (x == top && v > sv)) {  // a total order: the quad agrees
          top = x;
          sv = v;
        }
      };
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lead(top0, lead0, sc[4 * i], vs[8 * i]);
        lead(top0, lead0, sc[4 * i + 1], vs[8 * i + 1]);
        lead(top1, lead1, sc[4 * i + 2], vs[8 * i]);
        lead(top1, lead1, sc[4 * i + 3], vs[8 * i + 1]);
      }
#pragma unroll
      for (int d = 1; d <= 2; d *= 2) {
        lead(top0, lead0, __shfl_xor_sync(0xffffffffu, top0, d),
             __shfl_xor_sync(0xffffffffu, lead0, d));
        lead(top1, lead1, __shfl_xor_sync(0xffffffffu, top1, d),
             __shfl_xor_sync(0xffffffffu, lead1, d));
      }
      // A row never written (a zeroed pool's scale 0, V 0) can lead where
      // a padded query row sees past its chunk's frontier: 1 / 0 would make
      // the row NaN, and its K/V, written to the null page, every later
      // read of that page. Such a row folds the bare scales instead.
      if (lead0 == 0.f) lead0 = 1.f;
      if (lead1 == 0.f) lead1 = 1.f;
    }
    const float rs0 = 1.f / lead0, rs1 = 1.f / lead1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p0 = exp2_approx(sc[4 * i] - mx0);
      const float p1 = exp2_approx(sc[4 * i + 1] - mx0);
      const float p2 = exp2_approx(sc[4 * i + 2] - mx1);
      const float p3 = exp2_approx(sc[4 * i + 3] - mx1);
      sum0 += p0 + p1;  // l sums the unscaled p
      sum1 += p2 + p3;
      if constexpr (kQuant) {  // the V scale folds into P before rounding
        const float v0 = vs[8 * i], v1 = vs[8 * i + 1];
        pa[2 * i] = pack_bf16(p0 * v0 * rs0, p1 * v1 * rs0);
        pa[2 * i + 1] = pack_bf16(p2 * v0 * rs1, p3 * v1 * rs1);
      } else {
        pa[2 * i] = pack_bf16(p0, p1);      // row R0
        pa[2 * i + 1] = pack_bf16(p2, p3);  // row R1
      }
    }
    l0 = l0 * c0 + sum0;  // this thread's columns; the quad sums at the end
    l1 = l1 * c1 + sum1;
    const float oc0 = c0 * rs0, oc1 = c1 * rs1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= oc0;
      o[4 * i + 1] *= oc0;
      o[4 * i + 2] *= oc1;
      o[4 * i + 3] *= oc1;
    }

    // O += P V: 4 k-steps of 16 keys; P's k-step kk is pa[4 kk .. 4 kk + 3]
    mbar_wait(v_full(s), phase);
    if constexpr (kQuant) {
      widen<HD>(smem + L::kV + s * L::kTile, smem + L::kWide + kBf16Tile);
      fence_proxy_async();
      named_sync(kConsumerBar, kConsumers);
      if (lane == 0) mbar_arrive(empty(s));  // tiles and scales consumed
    }
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                pa[4 * kk + 3]};
      wgmma_rs(o, frag, sw128_desc(vt + kk * 16 * 128, kKvHalf, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    if constexpr (kQuant) {  // back to O's units: times S of each row
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        o[4 * i] *= lead0;
        o[4 * i + 1] *= lead0;
        o[4 * i + 2] *= lead1;
        o[4 * i + 3] *= lead1;
      }
    } else {
      if (lane == 0) mbar_arrive(empty(s));
    }
  }

#pragma unroll
  for (int d = 1; d <= 2; d *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.f / fmaxf(l0, kMinDenom);
  const float inv1 = 1.f / fmaxf(l1, kMinDenom);
  const int out_rows[2] = {R0, R1};
  const float inv[2] = {inv0, inv1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = out_rows[h];
    if (R >= rows) continue;  // past the chunk: computed, never stored
    __nv_bfloat16* dst = a.out + ((static_cast<size_t>(b) * a.chunk + R / group) *
                                      a.heads + kh * group + R % group) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * t) =
          pack_bf16(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
  }
}

// ------------------------------------------------------------------ host
// A 4-D map (HD, KH, PS, P) of a [P, PS, KH, HD] page pool: bf16 boxes of
// [PS rows][64] in the 128-byte swizzle, int8 boxes of [PS rows][HD]
// unswizzled. Pages past P arrive as zeros.
template <typename P, int HD>
bool encode_pool_map(CUtensorMap* map, const void* pool, int pages, int ps,
                     int kv_heads) {
  const flash_tc::EncodeTiled encode = flash_tc::encoder();
  if (encode == nullptr) return false;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const cuuint64_t e = sizeof(P);
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(kv_heads),
                              static_cast<cuuint64_t>(ps),
                              static_cast<cuuint64_t>(pages)};
  const cuuint64_t strides[3] = {HD * e, kv_heads * HD * e,
                                 static_cast<cuuint64_t>(ps) * kv_heads * HD * e};
  const cuuint32_t box[4] = {kQuant ? static_cast<cuuint32_t>(HD) : 64u, 1,
                             static_cast<cuuint32_t>(ps), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(pool), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                kQuant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A pool's map, encoded once per (pointer, shape) in each (P, HD)'s own
// cache: the serving loop calls every layer's pools again each step, and its
// host time is what shows.
template <typename P, int HD>
bool pool_map(CUtensorMap* map, const void* pool, int pages, int ps,
              int kv_heads) {
  struct Key {
    const void* ptr;
    int pages, ps, kv_heads;
    bool operator==(const Key& o) const {
      return ptr == o.ptr && pages == o.pages && ps == o.ps &&
             kv_heads == o.kv_heads;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.ptr) ^
             (static_cast<size_t>(k.pages) << 20) ^
             (static_cast<size_t>(k.ps) << 8) ^ static_cast<size_t>(k.kv_heads);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{pool, pages, ps, kv_heads};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode_pool_map<P, HD>(map, pool, pages, ps, kv_heads)) return false;
  if (cache.size() >= 4096) cache.clear();  // bound a long-lived process
  cache.emplace(key, *map);
  return true;
}

// q [B, C, H, HD] bf16 as (HD, H, C, B) in boxes (64, G, 64 / G, 1): one
// box is 64 packed rows of a kv head in order (one head_dim half), chunk
// tokens past C zero.
template <int HD>
bool q_map(CUtensorMap* map, const void* q, int batch, int chunk, int heads,
           int group) {
  const flash_tc::EncodeTiled encode = flash_tc::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(chunk),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {HD * 2, static_cast<cuuint64_t>(heads) * HD * 2,
                                 static_cast<cuuint64_t>(chunk) * heads * HD * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(group),
                             static_cast<cuuint32_t>(kRows / group), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(q),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct TcLaunch {
  CUtensorMap q, k, v;
  TcArgs a;
  int batch, q_by_tma;
  cudaStream_t stream;
};

template <typename P, int HD, int PS, bool WINDOW, bool SOFTCAP>
cudaError_t run(const TcLaunch& l) {
  constexpr int kBytes = Layout<P, HD>::kBytes;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      paged_prefill_tc_kernel<P, HD, PS, WINDOW, SOFTCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const int rows = l.a.chunk * (l.a.heads / l.a.kv_heads);
  const dim3 grid(l.batch, l.a.kv_heads, (rows + kRows - 1) / kRows);
  paged_prefill_tc_kernel<P, HD, PS, WINDOW, SOFTCAP>
      <<<grid, kThreads, kBytes, l.stream>>>(l.q, l.k, l.v, l.a, l.q_by_tma);
  return cudaGetLastError();
}

template <typename P, int HD, int PS>
cudaError_t by_mode(const TcLaunch& l, bool window, bool softcap) {
  if (window)
    return softcap ? run<P, HD, PS, true, true>(l) : run<P, HD, PS, true, false>(l);
  return softcap ? run<P, HD, PS, false, true>(l) : run<P, HD, PS, false, false>(l);
}

// bf16 q/out at head_dim HD (64 or 128) over pages of type P (bf16 or
// int8): the tensor-core body. Returns the cudaError_t of the launch.
template <typename P, int HD>
cudaError_t launch_prefill_tensor_cores(const paged::Args& a, int num_pages,
                                        int page_size, int has_window,
                                        int has_softcap, void* stream) {
  if (a.batch <= 0 || a.chunk <= 0 || a.kv_heads <= 0 ||
      a.heads % a.kv_heads != 0 || a.pages_per_row <= 0 || num_pages <= 0 ||
      (page_size != 8 && page_size != 16))
    return cudaErrorInvalidValue;
  const int group = a.heads / a.kv_heads;
  TcLaunch l;
  l.a = TcArgs{static_cast<const __nv_bfloat16*>(a.q), a.k_scale, a.v_scale,
               a.block_tables, a.positions, static_cast<__nv_bfloat16*>(a.out),
               a.chunk, a.heads, a.kv_heads, a.pages_per_row, a.window,
               a.sm_scale, a.softcap};
  l.batch = a.batch;
  l.stream = static_cast<cudaStream_t>(stream);
  l.q_by_tma = kRows % group == 0;
  if (l.q_by_tma && !q_map<HD>(&l.q, a.q, a.batch, a.chunk, a.heads, group))
    return cudaErrorInvalidValue;
  if (!l.q_by_tma) l.q = CUtensorMap{};  // unused: the consumers load Q
  if (!pool_map<P, HD>(&l.k, a.k_pages, num_pages, page_size, a.kv_heads) ||
      !pool_map<P, HD>(&l.v, a.v_pages, num_pages, page_size, a.kv_heads))
    return cudaErrorInvalidValue;
  const bool w = has_window != 0, c = has_softcap != 0;
  return page_size == 8 ? by_mode<P, HD, 8>(l, w, c) : by_mode<P, HD, 16>(l, w, c);
}

}  // namespace paged_tc
