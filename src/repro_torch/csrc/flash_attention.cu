// Full-sequence flash attention forward for Hopper (sm_90a): the
// mode-specialised kernel (B6) and the runtime-flag baseline (B7).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention.py:flash_attention          (B6)
//   src/repro/kernels/flash_attention.py:flash_attention_branchy  (B7)
// Both compute GQA attention of q [B, H, Sq, HD] over k, v [B, KH, Sk, HD]
// (query head h reads kv head h / (H / KH)) with the causal mask ki <= qi,
// the sliding window ki > qi - window and the logit softcap
// tanh(s / cap) * cap, an fp32 online softmax (NEG_INF = -2e38, denominator
// clamped at 1e-37, from paged_attention.cuh) and an output in q's type.
// Positions start at 0 for queries and keys alike (Sq may differ from Sk).
//
// The paper's kernel-level comparison is the difference between the two,
// and it is the only difference: both run one templated body per route and
// differ in the Mode policy alone.
//   B6  causal / window / softcap are template parameters (StaticMode): the
//       tanh exists only in the softcap instantiations, whole key tiles
//       above the causal diagonal or before the window are never loaded (the
//       loop bounds, the Pallas kernel's pl.when skip), and the per-element
//       mask runs only on tiles that cross the diagonal, the window's edge or
//       the ragged key tail, where the mode folds into each row's range of
//       visible keys (two compares an element).
//   B7  the mode arrives as an int32[3] device tensor (causal, window|0,
//       softcap|0) read by every block (FlagMode): every key tile is loaded
//       and multiplied, every score computes the capped and the uncapped
//       value and selects on the flag, and both masks are evaluated as
//       (flag == 0) || test on every tile. No template parameter depends on
//       the mode.
// On each route B6 and B7 compute the softcap with the same tanh (tanhf on
// CUDA cores, tanh.approx.f32 on tensor cores), so the softcap ratio
// compares one function.
//
// Two routes, chosen in the C entry points by dtype and head_dim (a
// semi-static choice, not a fallback: a bf16 head_dim-64 or -128 call never
// runs the CUDA-core body):
//
// bf16, head_dim HD = 64 or 128 — tensor cores (flash_tc_block, HD a
// template parameter; the text below is written for 128, and at 64 a tile
// is one 64-wide half, Q K^T takes 4 k-steps and P V is m64n64k16). What
// bounds the work
// is the products (at the prefill shape ~4 * Sq * Sk * HD flops per head
// against a few bytes per key), so both products run on wgmma:
//   - one block per (query tile of 128, head, batch row) of 288 threads:
//     two consumer warpgroups of 64 query rows each and one producer warp
//     (ptxas holds a thread to 168 registers here, and the body fits
//     without spills); query tiles are walked heaviest first (reversed
//     blockIdx.x), so causal blocks balance over the SMs;
//   - the producer loads Q once and K/V tiles of 128 keys into a 2-stage
//     ring in dynamic shared memory (160 KB with Q) with TMA over 4-D tensor
//     maps of the strided [B, S, H, HD] views (dims HD, S, H, B; 128-byte
//     swizzle; rows past S arrive as zeros, masked on the last tile), each
//     stage guarded by full (bytes) and empty (consumer) mbarriers;
//   - S = Q K^T as wgmma m64n128k16 from shared memory (both K-major); the
//     online softmax in registers (row max and sum over the accumulator
//     fragment with quad shuffles, ex2.approx of logits pre-scaled by
//     log2 e, one special-function op a score where exp2f's accurate path
//     takes several);
//     P rounded to bf16 in registers becomes the A operand of O += P V,
//     V read MN-major (the transpose bit); O (64 x 128 fp32 a warpgroup)
//     stays in registers across the key loop; out = O / max(l, 1e-37)
//     rounded to bf16 and stored through the output strides.
// The one new rounding against the CUDA-core body is P to bf16 before P V
// (as in SDPA's flash kernels).
//
// fp32 and head_dim 16 — CUDA cores (flash_block_simt): wgmma has no fp32
// mode but TF32, which would break the fp32 1e-4 tolerance (fp32 is
// instantiated at head_dim 16, 64 and 128), and head_dim 16 is the smoke
// configs' width. One block per (row, head, 16 queries) walks
// 16-key tiles in fp32 shared memory with fp32 FMAs.
//
// Tensors are read and written through element strides (batch, head,
// sequence; HD has unit stride), so the model's [B, S, H, HD] activations
// are views. The tensor-core route needs what TMA needs: 16-byte aligned
// bases and strides in multiples of 16 bytes (the wrapper checks).
#include "flash_tc.cuh"
#include "paged_attention.cuh"

namespace {

using paged::kMinDenom;
using paged::kNegInf;
using paged::kThreads;

constexpr int kBlockQ = 16;  // CUDA-core body: query rows per block
constexpr int kBlockK = 16;  // CUDA-core body: keys per tile

struct FlashArgs {
  int heads, kv_heads, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float sm_scale;
};

template <int HD>
struct FlashTile {
  float q[kBlockQ][HD + 1];
  float k[kBlockK][HD + 1];
  float v[kBlockK][HD];
  float s[kBlockQ][kBlockK];
  float acc[kBlockQ][HD];
  float m[kBlockQ];
  float l[kBlockQ];
  float corr[kBlockQ];
};

// The tanh of the softcap, one per route and the same for B6 and B7 on it:
// the CUDA-core body keeps the accurate tanhf (fp32 is held to 1e-4), the
// tensor-core body takes the hardware's tanh.approx.f32 (relative error
// about 2^-11, far inside bf16's tolerance; tanhf would cost ~20 more
// instructions a score).
struct AccurateTanh {
  __device__ float operator()(float x) const { return tanhf(x); }
};
struct FastTanh {
  __device__ float operator()(float x) const {
    return flash_tc::tanh_approx(x);
  }
};

// B6: the mode is code. Key tiles outside [lo, hi] are skipped.
template <bool CAUSAL, bool WINDOW, bool SOFTCAP>
struct StaticMode {
  int window;
  float softcap;
  template <class Tanh>
  __device__ float cap(float s) const {
    // times the reciprocal (hoisted out of the loops) instead of an IEEE
    // division a score; one ulp of the argument at most
    if constexpr (SOFTCAP) return Tanh{}(s * (1.f / softcap)) * softcap;
    return s;
  }
  __device__ bool visible(int qi, int ki) const {
    bool ok = true;
    if constexpr (CAUSAL) ok = ki <= qi;
    if constexpr (WINDOW) ok = ok && ki > qi - window;
    return ok;
  }
  __device__ float score(float s, int qi, int ki) const {
    return visible(qi, ki) ? cap<AccurateTanh>(s) : kNegInf;
  }
  // Which elements of a tile rows r0 and r1 may not see, on the tensor-core
  // fragment: element i is column kc + 8 (i / 4) + (i & 1) of row r0 (i & 2
  // clear) or r1. The mode folds into each row's range of visible columns,
  // so an element costs two compares against constants.
  struct TileMask {
    int first0, last0, first1, last1;
    __device__ bool hidden(int i) const {
      const int c = 8 * (i / 4) + (i & 1);
      return (i & 2) ? (c < first1 || c > last1) : (c < first0 || c > last0);
    }
  };
  __device__ TileMask tile_mask(int r0, int r1, int kc, int sk) const {
    TileMask m{-(1 << 30), sk - 1 - kc, -(1 << 30), sk - 1 - kc};
    if constexpr (CAUSAL) {
      m.last0 = min(m.last0, r0 - kc);
      m.last1 = min(m.last1, r1 - kc);
    }
    if constexpr (WINDOW) {
      m.first0 = r0 - window + 1 - kc;
      m.first1 = r1 - window + 1 - kc;
    }
    return m;
  }
  // whether some key of [k_first, k_last] is hidden from some query of
  // [q_first, q_last]: only such tiles need the per-element test
  __device__ bool edge(int q_first, int q_last, int k_first, int k_last) const {
    bool e = false;
    if constexpr (CAUSAL) e = k_last > q_first;
    if constexpr (WINDOW) e = e || k_first <= q_last - window;
    return e;
  }
  // key tiles of BK keys that can hold a visible key for queries [q0, q_last]
  template <int BK>
  __device__ int lo(int q0) const {
    if constexpr (WINDOW) return max(q0 - window + 1, 0) / BK;
    return 0;
  }
  template <int BK>
  __device__ int hi(int q_last, int n_tiles) const {
    if constexpr (CAUSAL) return min(q_last / BK, n_tiles - 1);
    return n_tiles - 1;
  }
};

// B7: the mode is data, read from device memory. Every tile runs.
struct FlagMode {
  int causal, window, softcap;
  template <class Tanh>
  __device__ float cap(float s) const {
    const float c = fmaxf(static_cast<float>(softcap), 1.f);
    float capped = Tanh{}(s * (1.f / c)) * c;
    // both sides computed: the compiler may not sink the tanh into a branch
    // on the flag
    asm volatile("" : "+f"(capped));
    return softcap > 0 ? capped : s;
  }
  __device__ bool visible(int qi, int ki) const {  // both tests, no shortcut
    return (causal == 0 | ki <= qi) & (window == 0 | ki > qi - window);
  }
  __device__ float score(float s, int qi, int ki) const {
    const float c = cap<AccurateTanh>(s);
    return visible(qi, ki) ? c : kNegInf;
  }
  // As StaticMode's, with both flag tests on every element: column c (from
  // kc) of row r is visible when c <= tail, (causal == 0 | c <= r - kc) and
  // (window == 0 | c > r - window - kc).
  struct TileMask {
    int causal, window, tail, diag0, diag1, edge0, edge1;
    __device__ bool hidden(int i) const {
      const int c = 8 * (i / 4) + (i & 1);
      const bool r1 = i & 2;
      return !((c <= tail) & (causal == 0 | c <= (r1 ? diag1 : diag0)) &
               (window == 0 | c > (r1 ? edge1 : edge0)));
    }
  };
  __device__ TileMask tile_mask(int r0, int r1, int kc, int sk) const {
    return TileMask{causal,         window,         sk - 1 - kc,
                    r0 - kc,        r1 - kc,        r0 - window - kc,
                    r1 - window - kc};
  }
  __device__ bool edge(int, int, int, int) const { return true; }
  template <int BK>
  __device__ int lo(int) const { return 0; }
  template <int BK>
  __device__ int hi(int, int n_tiles) const { return n_tiles - 1; }
};

// ------------------------------------ tensor-core body (bf16, HD 64 or 128)
constexpr int kTcRows = 128;               // query rows per block
constexpr int kTcKeys = 128;               // keys per tile
constexpr int kTcConsumers = 256;          // two warpgroups of 64 rows
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kHalfBytes = 128 * 128;      // [128 rows][64] bf16 = 16 KB
// [128 rows][HD] bf16: 32 KB at 128, 16 KB at 64
template <int HD>
constexpr int kTileBytes = (HD / 64) * kHalfBytes;
// Q, the K and V stages, 7 mbarriers, and slack to align the base to 1024
template <int HD>
constexpr int kTcSmem = kTileBytes<HD> * (1 + 2 * kStages) + 64 + 1024;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, class Mode>
__device__ void flash_tc_block(const CUtensorMap& tq, const CUtensorMap& tk,
                               const CUtensorMap& tv,
                               __nv_bfloat16* __restrict__ out,
                               const FlashArgs& a, const Mode& mode) {
  using namespace flash_tc;
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  constexpr int kHalves = HD / 64;
  constexpr int kTile = kTileBytes<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t s_q = base;
  const uint32_t s_k = base + kTile;                // + stage * tile
  const uint32_t s_v = base + (1 + kStages) * kTile;
  const uint32_t bars = base + (1 + 2 * kStages) * kTile;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.heads / a.kv_heads);
  const int n_tiles = (a.sk + kTcKeys - 1) / kTcKeys;
  const int lo = mode.template lo<kTcKeys>(q0);
  const int q_end = min(q0 + kTcRows, a.sq) - 1;  // last valid row
  const int hi = mode.template hi<kTcKeys>(q_end, n_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kTcConsumers / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kTcConsumers / 32) {  // producer warp: one thread issues TMA
    if (lane == 0) {
      mbar_expect_tx(q_full, kTile);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load_4d(s_q + hf * kHalfBytes, &tq, q_full, 64 * hf, q0, h, b);
      for (int j = 0; lo + j <= hi; ++j) {
        const int s = j % kStages, k0 = (lo + j) * kTcKeys;
        if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
        const uint32_t kd = s_k + s * kTile, vd = s_v + s * kTile;
        mbar_expect_tx(k_full(s), kTile);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
          tma_load_4d(kd + hf * kHalfBytes, &tk, k_full(s), 64 * hf, k0, kh, b);
        mbar_expect_tx(v_full(s), kTile);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
          tma_load_4d(vd + hf * kHalfBytes, &tv, v_full(s), 64 * hf, k0, kh, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread holds
  // rows r0 and r0 + 8, columns 8 i + 2 t (+1) of each 64 x 128 (S) and
  // 64 x HD (O) fragment
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int q_first = q0 + 64 * wg, q_last = q_first + 63;
  const int r0 = q_first + 16 * (warp % 4) + g, r1 = r0 + 8;
  const uint32_t q_rows = s_q + wg * 64 * 128;  // 64 rows of 128 B per half
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[64];
  uint32_t pa[32];

  mbar_wait(q_full, 0);
  for (int j = 0; lo + j <= hi; ++j) {
    const int s = j % kStages, k0 = (lo + j) * kTcKeys;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t kt = s_k + s * kTile, vt = s_v + s * kTile;

    // S = Q K^T: HD / 16 k-steps of 16 over head_dim, 4 in each 64-wide half
    mbar_wait(k_full(s), phase);
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(q_rows + off, 16, 1024),
               sw128_desc(kt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // logits in the log2 domain; the per-element test only where needed
    const bool masked = mode.edge(q_first, q_last, k0, k0 + kTcKeys - 1) ||
                        k0 + kTcKeys > a.sk;
    const auto hide = mode.tile_mask(r0, r1, k0 + 2 * t, a.sk);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float x = mode.template cap<FastTanh>(sc[i] * a.sm_scale) * kLog2e;
      sc[i] = masked && hide.hidden(i) ? kNegInf : x;
    }

    // online softmax over the quad that shares a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p0 = exp2_approx(sc[4 * i] - mx0);
      const float p1 = exp2_approx(sc[4 * i + 1] - mx0);
      const float p2 = exp2_approx(sc[4 * i + 2] - mx1);
      const float p3 = exp2_approx(sc[4 * i + 3] - mx1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[2 * i] = pack_bf16(p0, p1);      // row r0
      pa[2 * i + 1] = pack_bf16(p2, p3);  // row r1
    }
    l0 = l0 * c0 + sum0;  // this thread's columns; the quad sums at the end
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= c0;
      o[4 * i + 1] *= c0;
      o[4 * i + 2] *= c1;
      o[4 * i + 3] *= c1;
    }

    // O += P V: 8 k-steps of 16 keys; P's k-step kk is pa[4 kk .. 4 kk + 3]
    mbar_wait(v_full(s), phase);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                pa[4 * kk + 3]};
      wgmma_rs(o, frag, sw128_desc(vt + kk * 16 * 128, kHalfBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int d = 1; d <= 2; d *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.f / fmaxf(l0, kMinDenom);
  const float inv1 = 1.f / fmaxf(l1, kMinDenom);
  __nv_bfloat16* o_bh = out + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (r0 < a.sq)
      *reinterpret_cast<uint32_t*>(o_bh + r0 * a.o_ss + col) =
          pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r1 < a.sq)
      *reinterpret_cast<uint32_t*>(o_bh + r1 * a.o_ss + col) =
          pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

template <int HD, class Mode>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, FlashArgs a, Mode mode) {
  flash_tc_block<HD>(tq, tk, tv, out, a, mode);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_branchy_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const int* __restrict__ flags,
                            __nv_bfloat16* __restrict__ out, FlashArgs a) {
  flash_tc_block<HD>(tq, tk, tv, out, a,
                     FlagMode{flags[0], flags[1], flags[2]});
}

// ----------------------------------- CUDA-core body (fp32, or head_dim 16)
template <typename T, int HD, class Mode>
__device__ void flash_block_simt(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ out,
                                 const FlashArgs& a, const Mode& mode) {
  __shared__ FlashTile<HD> tile;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.heads / a.kv_heads);
  const int rows = min(kBlockQ, a.sq - q0);
  const T* q_bh = q + b * a.q_sb + h * a.q_sh;
  const T* k_bh = k + b * a.k_sb + kh * a.k_sh;
  const T* v_bh = v + b * a.v_sb + kh * a.v_sh;
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    tile.q[r][d] = paged::to_float(q_bh[(q0 + r) * a.q_ss + d]);
  }
  for (int i = tid; i < kBlockQ * HD; i += kThreads) (&tile.acc[0][0])[i] = 0.f;
  if (tid < kBlockQ) {
    tile.m[tid] = kNegInf;
    tile.l[tid] = 0.f;
  }
  const int n_tiles = (a.sk + kBlockK - 1) / kBlockK;
  const int lo = mode.template lo<kBlockK>(q0);
  const int hi = mode.template hi<kBlockK>(q0 + rows - 1, n_tiles);
  __syncthreads();
  for (int kb = lo; kb <= hi; ++kb) {
    const int k0 = kb * kBlockK;
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const bool in = k0 + t < a.sk;
      tile.k[t][d] = in ? paged::to_float(k_bh[(k0 + t) * a.k_ss + d]) : 0.f;
      tile.v[t][d] = in ? paged::to_float(v_bh[(k0 + t) * a.v_ss + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < rows * kBlockK; i += kThreads) {
      const int r = i / kBlockK, t = i % kBlockK;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += tile.q[r][d] * tile.k[t][d];
      const int ki = k0 + t;
      const float s = mode.score(dot * a.sm_scale, q0 + r, ki);
      tile.s[r][t] = ki < a.sk ? s : kNegInf;  // ragged key tail
    }
    __syncthreads();
    if (tid < rows) {
      const float m_prev = tile.m[tid];
      float m_new = m_prev;
#pragma unroll
      for (int t = 0; t < kBlockK; ++t) m_new = fmaxf(m_new, tile.s[tid][t]);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kBlockK; ++t) {
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
      float acc = tile.acc[r][d] * tile.corr[r];
#pragma unroll
      for (int t = 0; t < kBlockK; ++t) acc += tile.s[r][t] * tile.v[t][d];
      tile.acc[r][d] = acc;
    }
    __syncthreads();
  }
  T* o_bh = out + b * a.o_sb + h * a.o_sh;
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    o_bh[(q0 + r) * a.o_ss + d] =
        paged::from_float<T>(tile.acc[r][d] / fmaxf(tile.l[r], kMinDenom));
  }
}

template <typename T, int HD, class Mode>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      FlashArgs a, Mode mode) {
  flash_block_simt<T, HD>(q, k, v, out, a, mode);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_simt_branchy_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ flags,
                              T* __restrict__ out, FlashArgs a) {
  flash_block_simt<T, HD>(q, k, v, out, a,
                          FlagMode{flags[0], flags[1], flags[2]});
}

// Call launch(StaticMode<causal, window, softcap>{...}) for the mode's
// instantiation: the one place the mode becomes code.
template <class Launch>
cudaError_t with_static_mode(bool c, bool w, bool sc, int window,
                             float softcap, Launch&& launch) {
  if (c) {
    if (w) return sc ? launch(StaticMode<true, true, true>{window, softcap})
                     : launch(StaticMode<true, true, false>{window, softcap});
    return sc ? launch(StaticMode<true, false, true>{window, softcap})
              : launch(StaticMode<true, false, false>{window, softcap});
  }
  if (w) return sc ? launch(StaticMode<false, true, true>{window, softcap})
                   : launch(StaticMode<false, true, false>{window, softcap});
  return sc ? launch(StaticMode<false, false, true>{window, softcap})
            : launch(StaticMode<false, false, false>{window, softcap});
}

template <typename T, int HD>
cudaError_t launch_cuda_cores(const void* q, const void* k, const void* v,
                              void* out, const FlashArgs& a, int batch,
                              bool c, bool w, int window, bool sc,
                              float softcap, cudaStream_t s) {
  const dim3 g((a.sq + kBlockQ - 1) / kBlockQ, a.heads, batch);
  return with_static_mode(c, w, sc, window, softcap, [&](auto mode) {
    flash_simt_kernel<T, HD><<<g, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), a, mode);
    return cudaGetLastError();
  });
}

template <typename T, int HD>
cudaError_t launch_cuda_cores_branchy(const void* q, const void* k,
                                      const void* v, const int* flags,
                                      void* out, const FlashArgs& a,
                                      int batch, cudaStream_t s) {
  const dim3 g((a.sq + kBlockQ - 1) / kBlockQ, a.heads, batch);
  flash_simt_branchy_kernel<T, HD><<<g, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), flags, static_cast<T*>(out), a);
  return cudaGetLastError();
}

// ------------------------------------------ tensor-core route on the host
// A 4-D map (HD, S, heads, batch) of a bf16 [B, heads, S, HD] view with
// element strides (sb, sh, ss), read in boxes of [128 rows][64].
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int heads,
                int seq, long long sb, long long sh, long long ss) {
  const flash_tc::EncodeTiled encode = flash_tc::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, kTcKeys, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct TcMaps {
  CUtensorMap q, k, v;
};

template <int HD>
bool tc_maps(TcMaps* m, const void* q, const void* k, const void* v,
             const FlashArgs& a, int batch) {
  return tensor_map<HD>(&m->q, q, batch, a.heads, a.sq, a.q_sb, a.q_sh,
                        a.q_ss) &&
         tensor_map<HD>(&m->k, k, batch, a.kv_heads, a.sk, a.k_sb, a.k_sh,
                        a.k_ss) &&
         tensor_map<HD>(&m->v, v, batch, a.kv_heads, a.sk, a.v_sb, a.v_sh,
                        a.v_ss);
}

// Dynamic shared memory above 48 KB is opted into once per instantiation
// (the function-local statics below).
template <int HD>
cudaError_t launch_tensor_cores(const void* q, const void* k, const void* v,
                                void* out, const FlashArgs& a, int batch,
                                bool c, bool w, int window, bool sc,
                                float softcap, cudaStream_t s) {
  TcMaps m;
  if (!tc_maps<HD>(&m, q, k, v, a, batch)) return cudaErrorInvalidValue;
  auto* o = static_cast<__nv_bfloat16*>(out);
  return with_static_mode(c, w, sc, window, softcap, [&](auto mode) {
    using Mode = decltype(mode);
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        flash_tc_kernel<HD, Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem<HD>);
    if (opt_in != cudaSuccess) return opt_in;
    const dim3 g((a.sq + kTcRows - 1) / kTcRows, a.heads, batch);
    flash_tc_kernel<HD, Mode><<<g, kTcThreads, kTcSmem<HD>, s>>>(
        m.q, m.k, m.v, o, a, mode);
    return cudaGetLastError();
  });
}

template <int HD>
cudaError_t launch_tensor_cores_branchy(const void* q, const void* k,
                                        const void* v, const int* flags,
                                        void* out, const FlashArgs& a,
                                        int batch, cudaStream_t s) {
  TcMaps m;
  if (!tc_maps<HD>(&m, q, k, v, a, batch)) return cudaErrorInvalidValue;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_tc_branchy_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem<HD>);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 g((a.sq + kTcRows - 1) / kTcRows, a.heads, batch);
  flash_tc_branchy_kernel<HD><<<g, kTcThreads, kTcSmem<HD>, s>>>(
      m.q, m.k, m.v, flags, static_cast<__nv_bfloat16*>(out), a);
  return cudaGetLastError();
}

bool bad_shape(int batch, int heads, int kv_heads, int sq, int sk) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 ||
         sk <= 0 || batch > 65535 || heads > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); strides in elements
// (batch, head, sequence) for q, k, v and out. Return the cudaError_t of the
// launch (0 on success). Launch on `stream`, allocate nothing, do not sync.
// bf16 at head_dim 64 and 128 runs on tensor cores, the rest on CUDA cores
// (fp32 at 16, 64 and 128; bf16 at 16).
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int kv_heads, int sq, int sk, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int dtype, int head_dim, int causal,
    int has_window, int window, int has_softcap, float softcap,
    float sm_scale, void* stream) {
  if (bad_shape(batch, heads, kv_heads, sq, sk)) return cudaErrorInvalidValue;
  const FlashArgs a{heads, kv_heads, sq, sk, q_sb, q_sh, q_ss, k_sb, k_sh,
                    k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0, w = has_window != 0, sc = has_softcap != 0;
  if (dtype == 1 && head_dim == 64) return launch_tensor_cores<64>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 1 && head_dim == 128) return launch_tensor_cores<128>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 0 && head_dim == 16) return launch_cuda_cores<float, 16>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 0 && head_dim == 64) return launch_cuda_cores<float, 64>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 0 && head_dim == 128) return launch_cuda_cores<float, 128>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 1 && head_dim == 16) return launch_cuda_cores<__nv_bfloat16, 16>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  return cudaErrorInvalidValue;
}

// As flash_attention, with the mode as flags: int32[3] on the device,
// (causal 0/1, window or 0, softcap as an integer cap or 0).
extern "C" int flash_attention_branchy(
    const void* q, const void* k, const void* v, const void* flags, void* out,
    int batch, int heads, int kv_heads, int sq, int sk, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int dtype, int head_dim,
    float sm_scale, void* stream) {
  if (bad_shape(batch, heads, kv_heads, sq, sk)) return cudaErrorInvalidValue;
  const FlashArgs a{heads, kv_heads, sq, sk, q_sb, q_sh, q_ss, k_sb, k_sh,
                    k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* f = static_cast<const int*>(flags);
  if (dtype == 1 && head_dim == 64) return launch_tensor_cores_branchy<64>(q, k, v, f, out, a, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_tensor_cores_branchy<128>(q, k, v, f, out, a, batch, s);
  if (dtype == 0 && head_dim == 16) return launch_cuda_cores_branchy<float, 16>(q, k, v, f, out, a, batch, s);
  if (dtype == 0 && head_dim == 64) return launch_cuda_cores_branchy<float, 64>(q, k, v, f, out, a, batch, s);
  if (dtype == 0 && head_dim == 128) return launch_cuda_cores_branchy<float, 128>(q, k, v, f, out, a, batch, s);
  if (dtype == 1 && head_dim == 16) return launch_cuda_cores_branchy<__nv_bfloat16, 16>(q, k, v, f, out, a, batch, s);
  return cudaErrorInvalidValue;
}
