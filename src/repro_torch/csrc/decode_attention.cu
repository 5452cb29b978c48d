// Dense single-token decode attention with a scalar position (B5): the host
// entry point and kernel over the cluster-split body of
// paged_decode_split.cuh.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py:decode_attention
// One query token per row; its GQA group [G, HD] for kv head kh attends over
// cache rows 0..pos of that row, with the optional sliding window and logit
// softcap. The body is B1's (decode_split) with the block table j -> j
// (DenseRows): blocks of kDenseBlock rows past pos, or wholly before the
// window, are never read, and the rest are split into S contiguous shares
// over the S CTAs of one thread-block cluster, whose partial softmax states
// merge through distributed shared memory in the same launch.
//
// pos is a 0-dim int32 tensor read on the device, so a decode loop that
// advances it on the device never waits for the host; it must lie inside
// the cache (pos < seq_len). K and V are read through element strides
// (batch, sequence, head; HD has unit stride), 16 bytes a lane, so the
// model's [B, Smax, KH, HD] cache and the TPU layout [B, KH, S, HD] are
// both views the kernel takes without a copy, as long as the base and the
// strides are 16-byte multiples; q and out likewise by (batch, head)
// strides.
//
// Bound on the card: the K/V bytes of rows 0..pos (memory), as B1. At the
// burst shape (8 rows x 16 kv heads, pos 255) one CTA per (row, kv head)
// would be 128 CTAs walking 256 keys each; the split body spreads them over
// 4 x 128 CTAs (decode_splits), each lane with 16-byte loads of K and V
// rows in flight.
#include "paged_decode_split.cuh"

namespace {

using paged::kDenseBlock;
using paged_split::kMaxSplits;
using paged_split::kThreads;
using paged_split::kTileRows;
namespace cg = cooperative_groups;

struct DenseArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  int batch, heads, kv_heads, seq_len, splits, window;
  long long q_sb, q_sh, kv_sb, kv_ss, kv_sh, o_sb, o_sh;
  float sm_scale, softcap;
};

// One cluster of S CTAs per (batch row b, kv head kh, group tile of R query
// heads); blockIdx.z = tile * S + cluster rank.
template <typename T, int HD, bool WINDOW, bool SOFTCAP, int R>
__global__ void __launch_bounds__(kThreads)
    dense_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ pos,
                              T* __restrict__ out, DenseArgs a) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int tile = blockIdx.z / static_cast<int>(cg::this_cluster().num_blocks());
  const int group = a.heads / a.kv_heads;
  const int h0 = kh * group + tile * R;
  const int rows = min(R, group - tile * R);
  const int p = *pos;
  // structural skips: blocks past pos, or (window) wholly before the window
  const int n_blocks = (a.seq_len + kDenseBlock - 1) / kDenseBlock;
  const int p_hi = min(p / kDenseBlock, n_blocks - 1);
  int p_lo = 0;
  if constexpr (WINDOW) p_lo = max(p - a.window + 1, 0) / kDenseBlock;
  const paged::DenseRows<kDenseBlock> src{
      static_cast<size_t>(b * a.kv_sb + kh * a.kv_sh),
      static_cast<size_t>(a.kv_ss), a.seq_len};
  paged_split::decode_split<T, T, HD, kDenseBlock, WINDOW, SOFTCAP, R>(
      q + b * a.q_sb + h0 * a.q_sh, static_cast<size_t>(a.q_sh),
      out + b * a.o_sb + h0 * a.o_sh, static_cast<size_t>(a.o_sh), rows, k, v,
      nullptr, nullptr, src, p_lo, p_hi, p, a.sm_scale, a.window, a.softcap);
}

template <typename T, int HD, bool WINDOW, bool SOFTCAP, int R>
cudaError_t launch(const DenseArgs& a, cudaStream_t s) {
  const int tiles = (a.heads / a.kv_heads + R - 1) / R;
  return paged_split::launch_split(
      dense_decode_split_kernel<T, HD, WINDOW, SOFTCAP, R>, a.batch,
      a.kv_heads, tiles, a.splits, s, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pos,
      static_cast<T*>(a.out), a);
}

// one query row a CTA for G = 1 (MHA, the served model), kTileRows otherwise
template <typename T, int HD, bool WINDOW, bool SOFTCAP>
cudaError_t run(const DenseArgs& a, cudaStream_t s) {
  return a.heads == a.kv_heads ? launch<T, HD, WINDOW, SOFTCAP, 1>(a, s)
                               : launch<T, HD, WINDOW, SOFTCAP, kTileRows>(a, s);
}

template <typename T, int HD>
cudaError_t by_mode(const DenseArgs& a, bool w, bool c, cudaStream_t s) {
  if (w) return c ? run<T, HD, true, true>(a, s) : run<T, HD, true, false>(a, s);
  return c ? run<T, HD, false, true>(a, s) : run<T, HD, false, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); head_dim 16, 64 or
// 128. Strides are in
// elements; k and v share theirs. splits: CTAs a cluster, 1-8. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for splits
// outside 1-8). Launches on `stream`, allocates nothing, does not sync.
extern "C" int dense_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    int batch, int heads, int kv_heads, int seq_len, int splits,
    long long q_sb, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, long long o_sb, long long o_sh, int dtype, int head_dim,
    int has_window, int window, int has_softcap, float softcap,
    float sm_scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_len <= 0 || splits < 1 ||
      splits > kMaxSplits)
    return cudaErrorInvalidValue;
  const DenseArgs a{q, k, v, static_cast<const int*>(pos), out, batch, heads,
                    kv_heads, seq_len, splits, window, q_sb, q_sh, kv_sb,
                    kv_ss, kv_sh, o_sb, o_sh, sm_scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = has_window != 0, c = has_softcap != 0;
  if (dtype == 0 && head_dim == 16) return by_mode<float, 16>(a, w, c, s);
  if (dtype == 0 && head_dim == 64) return by_mode<float, 64>(a, w, c, s);
  if (dtype == 0 && head_dim == 128) return by_mode<float, 128>(a, w, c, s);
  if (dtype == 1 && head_dim == 16) return by_mode<__nv_bfloat16, 16>(a, w, c, s);
  if (dtype == 1 && head_dim == 64) return by_mode<__nv_bfloat16, 64>(a, w, c, s);
  if (dtype == 1 && head_dim == 128) return by_mode<__nv_bfloat16, 128>(a, w, c, s);
  return cudaErrorInvalidValue;
}
