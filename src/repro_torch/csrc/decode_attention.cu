// Dense single-token decode attention with a scalar position (B5): the host
// entry point and kernel over the shared body in paged_attention.cuh.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py:decode_attention
// One query token per row; its GQA group [G, HD] for kv head kh attends over
// cache rows 0..pos of that row, with the optional sliding window and logit
// softcap. The body is B1's with the block table j -> j (DenseRows): blocks
// of kDenseBlock rows past pos, or wholly before the window, are never read.
//
// pos is a 0-dim int32 tensor read on the device, so a decode loop that
// advances it on the device never waits for the host; it must lie inside
// the cache (pos < seq_len). K and V are read
// through element strides (batch, sequence, head; HD has unit stride), so
// the model's [B, Smax, KH, HD] cache and the TPU layout [B, KH, S, HD] are
// both views the kernel takes without a copy; q and out likewise by (batch,
// head) strides.
//
// Bound on the card: the K/V bytes of rows 0..pos (memory), as B1.
#include "paged_attention.cuh"

namespace {

using paged::kDecodeRows;
using paged::kDenseBlock;
using paged::kThreads;

struct DenseArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  int batch, heads, kv_heads, seq_len, window;
  long long q_sb, q_sh, kv_sb, kv_ss, kv_sh, o_sb, o_sh;
  float sm_scale, softcap;
};

// One block per (batch row b, kv head kh, group tile of kDecodeRows heads).
template <typename T, int HD, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, DenseArgs a) {
  __shared__ paged::Tile<HD, kDenseBlock, kDecodeRows> tile;
  const int tid = threadIdx.x;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int group = a.heads / a.kv_heads;
  const int h0 = kh * group + blockIdx.z * kDecodeRows;
  const int rows = min(kDecodeRows,
                       group - static_cast<int>(blockIdx.z) * kDecodeRows);
  const int p = *pos;
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    tile.q[r][d] = paged::to_float(q[b * a.q_sb + (h0 + r) * a.q_sh + d]);
  }
  if (tid < rows) tile.qi[tid] = p;
  const int n_blocks = (a.seq_len + kDenseBlock - 1) / kDenseBlock;
  const int p_hi = min(p / kDenseBlock, n_blocks - 1);
  int p_lo = 0;
  if constexpr (WINDOW) p_lo = max(p - a.window + 1, 0) / kDenseBlock;
  __syncthreads();
  const paged::DenseRows<kDenseBlock> src{
      static_cast<size_t>(b * a.kv_sb + kh * a.kv_sh),
      static_cast<size_t>(a.kv_ss), a.seq_len};
  paged::attend_pages<T, HD, kDenseBlock, WINDOW, SOFTCAP, kDecodeRows>(
      tile, k, v, nullptr, nullptr, src, rows, p_lo, p_hi, a.sm_scale,
      a.window, a.softcap);
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    out[b * a.o_sb + (h0 + r) * a.o_sh + d] = paged::from_float<T>(
        tile.acc[r][d] / fmaxf(tile.l[r], paged::kMinDenom));
  }
}

template <typename T, int HD, bool WINDOW, bool SOFTCAP>
cudaError_t run(const DenseArgs& a, cudaStream_t s) {
  const int group = a.heads / a.kv_heads;
  const dim3 grid(a.batch, a.kv_heads,
                  (group + kDecodeRows - 1) / kDecodeRows);
  dense_decode_kernel<T, HD, WINDOW, SOFTCAP><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pos, static_cast<T*>(a.out), a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_mode(const DenseArgs& a, bool w, bool c, cudaStream_t s) {
  if (w) return c ? run<T, HD, true, true>(a, s) : run<T, HD, true, false>(a, s);
  return c ? run<T, HD, false, true>(a, s) : run<T, HD, false, false>(a, s);
}

template <typename T>
cudaError_t by_shape(const DenseArgs& a, int head_dim, bool w, bool c,
                     cudaStream_t s) {
  if (head_dim == 16) return by_mode<T, 16>(a, w, c, s);
  if (head_dim == 128) return by_mode<T, 128>(a, w, c, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). Strides are in
// elements; k and v share theirs. Returns the cudaError_t of the launch (0 on
// success). Launches on `stream`, allocates nothing, does not sync.
extern "C" int dense_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    int batch, int heads, int kv_heads, int seq_len, long long q_sb,
    long long q_sh, long long kv_sb, long long kv_ss, long long kv_sh,
    long long o_sb, long long o_sh, int dtype, int head_dim, int has_window,
    int window, int has_softcap, float softcap, float sm_scale,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_len <= 0)
    return cudaErrorInvalidValue;
  const DenseArgs a{q, k, v, static_cast<const int*>(pos), out, batch, heads,
                    kv_heads, seq_len, window, q_sb, q_sh, kv_sb, kv_ss,
                    kv_sh, o_sb, o_sh, sm_scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = has_window != 0, c = has_softcap != 0;
  if (dtype == 0) return by_shape<float>(a, head_dim, w, c, s);
  if (dtype == 1) return by_shape<__nv_bfloat16>(a, head_dim, w, c, s);
  return cudaErrorInvalidValue;
}
