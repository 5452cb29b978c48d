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
//
// The paper's kernel-level comparison is the difference between the two:
//   B6  causal / window / softcap are template parameters (StaticMode): the
//       tanh exists only in the softcap instantiations, and whole key tiles
//       above the causal diagonal or before the window are never loaded —
//       the loop bounds are the Pallas kernel's pl.when skip.
//   B7  the mode arrives as an int32[3] device tensor (causal, window|0,
//       softcap|0) read by every block (FlagMode): every tile of every row
//       is loaded, every score computes the capped and the uncapped value and
//       selects on the flag, and both masks are evaluated as
//       (flag == 0) || test. No template parameter depends on the mode.
//
// One block serves one (batch row, query head, tile of kBlockQ queries) and
// walks the key tiles in order (the TPU grid's sequential axis becomes the
// block's own loop); q, K, V, scores and the accumulator sit in fp32 shared
// memory (~34 KB at HD 128, under the 48 KB static limit). Tensors are read
// and written through element strides (batch, head, sequence; HD has unit
// stride), so the model's [B, S, H, HD] activations are views, and ragged
// sequence tails are masked (Pallas asserts Sq, Sk multiples of its blocks).
//
// Bound on the card: at the prefill shapes the work is ~Sq*Sk*HD*4 flops per
// head (half of it for causal), far above the bytes of q, K, V and the
// output, so the bound is the tensor cores' rate. This simple version runs
// fp32 FMAs out of shared memory, without tensor cores, TMA or wgmma: right
// first, fast in a later change.
#include "paged_attention.cuh"

namespace {

using paged::kMinDenom;
using paged::kNegInf;
using paged::kThreads;

constexpr int kBlockQ = 16;  // query rows per block
constexpr int kBlockK = 16;  // keys per tile

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

// B6: the mode is code. Key tiles outside [lo, hi] are skipped.
template <bool CAUSAL, bool WINDOW, bool SOFTCAP>
struct StaticMode {
  int window;
  float softcap;
  __device__ float score(float s, int qi, int ki) const {
    if constexpr (SOFTCAP) s = tanhf(s / softcap) * softcap;
    bool ok = true;
    if constexpr (CAUSAL) ok = ki <= qi;
    if constexpr (WINDOW) ok = ok && ki > qi - window;
    return ok ? s : kNegInf;
  }
  // key tiles that can hold a visible key for queries [q0, q_last]
  __device__ int lo(int q0) const {
    if constexpr (WINDOW) return max(q0 - window + 1, 0) / kBlockK;
    return 0;
  }
  __device__ int hi(int q_last, int n_tiles) const {
    if constexpr (CAUSAL) return min(q_last / kBlockK, n_tiles - 1);
    return n_tiles - 1;
  }
};

// B7: the mode is data, read from device memory. Every tile runs.
struct FlagMode {
  int causal, window, softcap;
  __device__ float score(float s, int qi, int ki) const {
    const float cap = fmaxf(static_cast<float>(softcap), 1.f);
    const float capped = tanhf(s / cap) * cap;
    s = softcap > 0 ? capped : s;  // both sides computed
    const bool ok = (causal == 0 || ki <= qi) &&
                    (window == 0 || ki > qi - window);
    return ok ? s : kNegInf;
  }
  __device__ int lo(int) const { return 0; }
  __device__ int hi(int, int n_tiles) const { return n_tiles - 1; }
};

template <typename T, int HD, class Mode>
__device__ void flash_block(const T* __restrict__ q, const T* __restrict__ k,
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
  const int lo = mode.lo(q0), hi = mode.hi(q0 + rows - 1, n_tiles);
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

template <typename T, int HD, bool CAUSAL, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, FlashArgs a,
                 int window, float softcap) {
  flash_block<T, HD>(q, k, v, out, a,
                     StaticMode<CAUSAL, WINDOW, SOFTCAP>{window, softcap});
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_branchy_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ flags,
                         T* __restrict__ out, FlashArgs a) {
  flash_block<T, HD>(q, k, v, out, a, FlagMode{flags[0], flags[1], flags[2]});
}

dim3 grid_of(const FlashArgs& a, int batch) {
  return dim3((a.sq + kBlockQ - 1) / kBlockQ, a.heads, batch);
}

template <typename T, int HD>
cudaError_t specialised(const void* q, const void* k, const void* v,
                        void* out, const FlashArgs& a, int batch, bool causal,
                        bool w, int window, bool c, float softcap,
                        cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const dim3 g = grid_of(a, batch);
#define REPRO_FLASH(C, W, S)                                                 \
  flash_kernel<T, HD, C, W, S><<<g, kThreads, 0, s>>>(qt, kt, vt, ot, a,     \
                                                      window, softcap)
  if (causal) {
    if (w) { if (c) REPRO_FLASH(true, true, true); else REPRO_FLASH(true, true, false); }
    else   { if (c) REPRO_FLASH(true, false, true); else REPRO_FLASH(true, false, false); }
  } else {
    if (w) { if (c) REPRO_FLASH(false, true, true); else REPRO_FLASH(false, true, false); }
    else   { if (c) REPRO_FLASH(false, false, true); else REPRO_FLASH(false, false, false); }
  }
#undef REPRO_FLASH
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t branchy(const void* q, const void* k, const void* v,
                    const int* flags, void* out, const FlashArgs& a,
                    int batch, cudaStream_t s) {
  flash_branchy_kernel<T, HD><<<grid_of(a, batch), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), flags, static_cast<T*>(out), a);
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
  if (dtype == 0 && head_dim == 16)
    return specialised<float, 16>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 0 && head_dim == 128)
    return specialised<float, 128>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 1 && head_dim == 16)
    return specialised<__nv_bfloat16, 16>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
  if (dtype == 1 && head_dim == 128)
    return specialised<__nv_bfloat16, 128>(q, k, v, out, a, batch, c, w, window, sc, softcap, s);
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
  if (dtype == 0 && head_dim == 16) return branchy<float, 16>(q, k, v, f, out, a, batch, s);
  if (dtype == 0 && head_dim == 128) return branchy<float, 128>(q, k, v, f, out, a, batch, s);
  if (dtype == 1 && head_dim == 16) return branchy<__nv_bfloat16, 16>(q, k, v, f, out, a, batch, s);
  if (dtype == 1 && head_dim == 128) return branchy<__nv_bfloat16, 128>(q, k, v, f, out, a, batch, s);
  return cudaErrorInvalidValue;
}
