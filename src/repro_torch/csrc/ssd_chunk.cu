// Mamba-2 SSD chunked scan for Hopper (sm_90a): kernel B8.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk.py:ssd_chunk
// and computes what its per-chunk body computes (arXiv:2405.21060 §6), the
// chunked form of ssd_scan: for every (batch row, head), chunk after chunk
// of L rows,
//   cum   = inclusive prefix sum of dt·A over the chunk, total = cum[L-1]
//   y[l]  = Σ_{l'≤l} (C_l·B_l') exp(cum_l − cum_l') dt_l' x_l'     (intra)
//         + exp(cum_l) (C_l · stateᵀ)                               (inter)
//   state = exp(total)·state + Σ_l x_lᵀ ⊗ B_l · exp(total − cum_l) dt_l
// with the inter term taken from the state *before* the chunk's update, and
// every sum in fp32. Inputs x [B, S, H, P] and b, c [B, S, G, N] in the
// model type (head h reads group h / heads_per_group; a stride-0 head axis
// over one group is read as it is), dt [B, S, H] and A [H] in fp32, all
// through element strides with a unit last axis. Outputs: y [B, S, H, P]
// contiguous in x's type and the final state [B, H, P, N] fp32.
//
// Design. The TPU runs the chunks as a sequential third grid axis with the
// state in VMEM scratch. Here one block serves one (batch row, head) and a
// loop over chunks inside the block takes that axis's place; the [P, N]
// fp32 state (33 KB at 64 x 128, rows padded by one float against bank
// conflicts) stays in shared memory for the whole loop and is written to
// device memory once, after the last chunk. A whole chunk of B and C at
// L 256, N 128 would be 128 KB each in fp32, so the chunk is walked in tiles
// of T = min(L, 32) rows: for each query tile, the key tiles at or below the
// diagonal give the decay-masked T x T matrix G = (C·Bᵀ)·decay·dt, then
// G·x; the decay is exponentiated only where l' ≤ l and G is an explicit 0
// above the diagonal (the Pallas kernel takes exp of every pair and selects,
// which can meet inf·0). The state update runs after every query tile of
// the chunk, over the same key tiles weighted by exp(total − cum)·dt. About
// 80 KB of dynamic shared memory per block: two blocks per SM, the 256
// (batch, head) blocks of an 8 x 32 prefill in one wave on 132 SMs.
//
// Ragged S. L is a template constant and is never rounded to S: rows past S
// are not loaded (dt, x, B, C read as 0, so their decay is 1 and their input
// is 0, ssd_scan's dt = 0 padding) and not stored, so any S (also S < L)
// gives ssd_scan's result.
//
// Bound on the card: at the prefill shape (8 x 1024 tokens, 32 heads of
// 64, state 128, bf16) the causal half of the L x L products and the state
// terms come to ~21 GFLOP against ~80 MB of inputs and outputs: 0.02 ms at
// either the tensor cores' bf16 rate or the HBM rate. This first version
// runs fp32 FMAs out of shared memory, one element per thread per product,
// without tensor cores, TMA or wgmma: right first, fast in a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct SsdArgs {
  int seqlen, heads, heads_per_group;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dt_sb, dt_ss, dt_sh;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory layout of one block, in floats.
template <int L, int P, int N>
struct SsdShape {
  static constexpr int kT = L < 32 ? L : 32;  // rows per tile
  static_assert(L % kT == 0, "chunk must be a multiple of the tile");
  static_assert(L <= kThreads, "one thread per chunk row in the scan");
  static constexpr int kRowN = N + 1;  // padded B, C and state rows
  static constexpr int kState = P * kRowN;
  static constexpr int kTileN = kT * kRowN;
  static constexpr int kTileX = kT * P;
  static constexpr int kTileG = kT * kT;
  static constexpr int kFloats =
      kState + 2 * kTileN + kTileX + kTileG + 3 * L + kWarps;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static constexpr int kAccY = (kT * P + kThreads - 1) / kThreads;
  static constexpr int kAccS = (P * N + kThreads - 1) / kThreads;
};

// Inclusive prefix sum over the block, one value per thread.
__device__ float block_inclusive_scan(float v, float* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? wtot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    if (lane < kWarps) wtot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v += wtot[warp - 1];
  return v;
}

// rows [r0, r0 + kT) of a [S, W] operand (row stride `ss`, unit column
// stride) into dst[kT][ROW] as fp32, times `w[j]` when given; rows past S
// are zero.
template <typename T, int W, int ROW, int TR>
__device__ void load_tile(float* dst, const T* src, long long ss, int r0,
                          int seqlen, const float* w) {
  for (int e = threadIdx.x; e < TR * W; e += kThreads) {
    const int j = e / W, k = e % W;
    const int r = r0 + j;
    float v = 0.f;
    if (r < seqlen) {
      v = to_float(src[r * ss + k]);
      if (w != nullptr) v *= w[j];
    }
    dst[j * ROW + k] = v;
  }
}

template <typename T, int L, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a, T* __restrict__ y,
                     float* __restrict__ state_out, const SsdArgs args) {
  using S = SsdShape<L, P, N>;
  constexpr int TR = S::kT, RN = S::kRowN;
  extern __shared__ float smem[];
  float* st = smem;                 // [P][RN]  carried state
  float* cs = st + S::kState;       // [TR][RN] C rows of the query tile
  float* bs = cs + S::kTileN;       // [TR][RN] B rows of a key tile
  float* xs = bs + S::kTileN;       // [TR][P]  x rows of a key tile
  float* gs = xs + S::kTileX;       // [TR][TR] (C·Bᵀ)·decay·dt
  float* dts = gs + S::kTileG;      // [L] dt of the chunk, 0 past S
  float* cum = dts + L;             // [L] inclusive prefix sum of dt·A
  float* win = cum + L;             // [L] exp(total − cum)·dt
  float* wtot = win + L;            // [kWarps] scan partials

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / args.heads_per_group;
  const int seqlen = args.seqlen;
  const float A = a[h];
  const T* xb = x + bb * args.x_sb + h * args.x_sh;
  const T* bgb = bm + bb * args.b_sb + g * args.b_sg;
  const T* cgb = cm + bb * args.c_sb + g * args.c_sg;
  const float* dtb = dt + bb * args.dt_sb + h * args.dt_sh;
  const long long y_ss = static_cast<long long>(args.heads) * P;
  T* yb = y + (static_cast<long long>(bb) * seqlen * args.heads + h) * P;

  for (int e = tid; e < P * N; e += kThreads) st[(e / N) * RN + e % N] = 0.f;

  const int n_chunks = (seqlen + L - 1) / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * L;
    const int rows = min(L, seqlen - r0);
    const int tiles = (rows + TR - 1) / TR;  // tiles holding a real row
    const T* xc = xb + r0 * args.x_ss;
    const T* bc = bgb + r0 * args.b_ss;
    const T* cc = cgb + r0 * args.c_ss;
    // 1. dt and the cumulative log-decay of the chunk
    float v = 0.f;
    if (tid < L) {
      const float d = tid < rows ? dtb[(r0 + tid) * args.dt_ss] : 0.f;
      dts[tid] = d;
      v = d * A;
    }
    v = block_inclusive_scan(v, wtot);
    if (tid < L) cum[tid] = v;
    __syncthreads();
    const float total = cum[L - 1];
    if (tid < L) win[tid] = expf(total - cum[tid]) * dts[tid];

    // 2. outputs, one query tile at a time
    for (int qt = 0; qt < tiles; ++qt) {
      const int q0 = qt * TR;
      load_tile<T, N, RN, TR>(cs, cc, args.c_ss, q0, rows, nullptr);
      float acc[S::kAccY];
#pragma unroll
      for (int k = 0; k < S::kAccY; ++k) acc[k] = 0.f;
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * TR;
        __syncthreads();  // the previous tile's readers are done
        load_tile<T, N, RN, TR>(bs, bc, args.b_ss, k0, rows, nullptr);
        load_tile<T, P, P, TR>(xs, xc, args.x_ss, k0, rows, nullptr);
        __syncthreads();
        for (int e = tid; e < TR * TR; e += kThreads) {
          const int i = e / TR, j = e % TR;
          const int li = q0 + i, lj = k0 + j;
          float gv = 0.f;
          if (lj <= li) {  // decay only on the causal triangle
            float dot = 0.f;
#pragma unroll 8
            for (int n = 0; n < N; ++n) dot += cs[i * RN + n] * bs[j * RN + n];
            gv = dot * expf(cum[li] - cum[lj]) * dts[lj];
          }
          gs[e] = gv;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < S::kAccY; ++k) {
          const int e = tid + k * kThreads;
          if (e < TR * P) {
            const int i = e / P, p = e % P;
            float s = 0.f;
#pragma unroll 8
            for (int j = 0; j < TR; ++j) s += gs[i * TR + j] * xs[j * P + p];
            acc[k] += s;
          }
        }
      }
      // inter-chunk term, from the state before this chunk's update
#pragma unroll
      for (int k = 0; k < S::kAccY; ++k) {
        const int e = tid + k * kThreads;
        if (e < TR * P) {
          const int i = e / P, p = e % P;
          float s = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n) s += cs[i * RN + n] * st[p * RN + n];
          const int r = q0 + i;
          if (r < rows)
            yb[(r0 + r) * y_ss + p] = from_float<T>(acc[k] + expf(cum[r]) * s);
        }
      }
      __syncthreads();  // cs and the state's readers are done
    }

    // 3. the state update, after every query tile of the chunk
    float sacc[S::kAccS];
#pragma unroll
    for (int k = 0; k < S::kAccS; ++k) sacc[k] = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {
      const int k0 = kt * TR;
      __syncthreads();
      load_tile<T, N, RN, TR>(bs, bc, args.b_ss, k0, rows, win + k0);
      load_tile<T, P, P, TR>(xs, xc, args.x_ss, k0, rows, nullptr);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < S::kAccS; ++k) {
        const int e = tid + k * kThreads;
        if (e < P * N) {
          const int p = e / N, n = e % N;
          float s = 0.f;
#pragma unroll 8
          for (int j = 0; j < TR; ++j) s += xs[j * P + p] * bs[j * RN + n];
          sacc[k] += s;
        }
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int k = 0; k < S::kAccS; ++k) {
      const int e = tid + k * kThreads;
      if (e < P * N) {
        float* sp = st + (e / N) * RN + e % N;
        *sp = *sp * decay + sacc[k];
      }
    }
    __syncthreads();  // the next chunk reads the whole state
  }

  float* so = state_out + (static_cast<long long>(bb) * args.heads + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) so[e] = st[(e / N) * RN + e % N];
}

template <typename T, int L, int P, int N>
cudaError_t launch(const void* x, const void* b, const void* c,
                   const float* dt, const float* a, void* y, float* state,
                   int batch, const SsdArgs& args, cudaStream_t s) {
  using Shape = SsdShape<L, P, N>;
  auto kernel = ssd_chunk_kernel<T, L, P, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape::kBytes));
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(args.heads, batch), kThreads, Shape::kBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), dt, a, static_cast<T*>(y), state, args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_shape(int chunk, int headdim, int state_dim, const void* x,
                     const void* b, const void* c, const float* dt,
                     const float* a, void* y, float* state, int batch,
                     const SsdArgs& args, cudaStream_t s) {
#define REPRO_SSD(L_, P_, N_)                                               \
  if (chunk == L_ && headdim == P_ && state_dim == N_)                      \
    return launch<T, L_, P_, N_>(x, b, c, dt, a, y, state, batch, args, s)
  REPRO_SSD(256, 64, 128);  // mamba2-370m
  REPRO_SSD(4, 16, 16);     // the smoke config, the JAX tests' chunks
  REPRO_SSD(8, 16, 16);
  REPRO_SSD(16, 16, 16);
#undef REPRO_SSD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); dt, a and state are
// float32. Strides in elements: x (batch, seq, head), b and c (batch, seq,
// group), dt (batch, seq, head); y is written contiguous [B, S, H, P] and
// state [B, H, P, N]. Return the cudaError_t of the launch (0 on success).
// Launch on `stream`, allocate nothing, do not sync.
extern "C" int ssd_chunk(
    const void* x, const void* b, const void* c, const void* dt,
    const void* a, void* y, void* state, int batch, int seqlen, int heads,
    int heads_per_group, long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, long long dt_sb, long long dt_ss,
    long long dt_sh, int dtype, int chunk, int headdim, int state_dim,
    void* stream) {
  if (batch <= 0 || batch > 65535 || seqlen <= 0 || heads <= 0 ||
      heads_per_group <= 0 || heads % heads_per_group != 0)
    return cudaErrorInvalidValue;
  const SsdArgs args{seqlen, heads, heads_per_group, x_sb, x_ss, x_sh,
                     b_sb,   b_ss,  b_sg,            c_sb, c_ss, c_sg,
                     dt_sb,  dt_ss, dt_sh};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_shape<float>(chunk, headdim, state_dim, x, b, c, dtf, af, y,
                           sf, batch, args, s);
  if (dtype == 1)
    return by_shape<__nv_bfloat16>(chunk, headdim, state_dim, x, b, c, dtf,
                                   af, y, sf, batch, args, s);
  return cudaErrorInvalidValue;
}
