// The sampling tail of every serving step, for sm_90a: JAX's threefry
// categorical draw (Gumbel-max) and greedy argmax per row, the key split,
// in one launch. The plain version is repro_torch/prng.py; the wrapper is
// repro_torch/kernels/sampling.py, whose docstring states the contract.
//
// Grid (ceil(V / kTile), S), kThreads threads a CTA, kPerThread elements a
// thread (strided by kThreads, so a warp's loads coalesce). A CTA of a
// sampled row hashes each element's 64-bit counter with the row's sample key
// (threefry-2x32), turns the bits into a gumbel in the logits' type and
// scores it against the scaled logit; a greedy row scores the raw logit. The
// CTA reduces its best (score, index) pair to one 64-bit word — the score in
// an order-preserving encoding above the complement of the index, so the
// first index wins a tie as JAX's argmax does — and folds it into the row's
// word with one atomicMax. The row's last CTA to finish (an atomic ticket)
// reads the word, writes the token, and resets the word and the ticket to
// zero: the workspace is zero before and after every launch, so a CUDA graph
// replays the kernel with no memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN: the gumbel's minval

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

// Threefry-2x32 of the counter (x0, x1) under (k0, k1), in place: JAX's
// unrolled lowering (_threefry2x32_lowering), 20 rounds, 5 key injections.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// float32 log correctly rounded (computed in double), as prng._log.
__device__ __forceinline__ float log_rn(float x) {
  return __double2float_rn(log(static_cast<double>(x)));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> struct Elem;

// float32: 23 random mantissa bits; each op in float32.
template <> struct Elem<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float x) { return x; }
  __device__ static float gumbel(uint32_t bits) {
    float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    u = fmaxf(kTiny, __fadd_rn(u, kTiny));  // u * (1 - tiny) + tiny, max
    return -log_rn(-log_rn(u));
  }
};

// bfloat16: 8 random bits (7 kept as the mantissa); each op in float32,
// rounded to bfloat16 (XLA's CPU lowering, prng's module docstring).
template <> struct Elem<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float round(float x) { return bf16_round(x); }
  __device__ static float gumbel(uint32_t bits) {
    const uint32_t word = (((bits & 0xFFu) >> 1) | 0x3F80u) << 16;
    float u = bf16_round(__uint_as_float(word) - 1.0f);
    u = bf16_round(__fadd_rn(u, kTiny));
    u = bf16_round(fmaxf(kTiny, u));
    const float inner = bf16_round(log_rn(u));
    return -bf16_round(log_rn(-inner));
  }
};

// Order-preserving encoding of a float into 32 bits (NaN above +inf, as
// JAX's argmax takes a NaN first), over the complement of the index.
__device__ __forceinline__ unsigned long long pack(float score, uint32_t v) {
  uint32_t b = __float_as_uint(score);
  b = (score != score) ? 0xFFFFFFFFu : (b & 0x80000000u) ? ~b
                                                         : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | (0xFFFFFFFFu - v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_rows_kernel(const T* __restrict__ logits, long long row_stride,
                   int vocab, const float* __restrict__ temps,
                   const uint8_t* __restrict__ greedy,
                   const int32_t* __restrict__ keys,
                   int32_t* __restrict__ new_keys, int32_t* __restrict__ tok,
                   unsigned long long* __restrict__ best,
                   unsigned int* __restrict__ ticket,
                   float* __restrict__ scores, int split, float temperature) {
  const int row = blockIdx.y;
  const bool is_greedy = greedy != nullptr && greedy[row] != 0;
  uint32_t k0, k1;
  float t;
  if (split) {  // the row's key, split in 2: (sample key, new key)
    const uint32_t r0 = static_cast<uint32_t>(keys[2 * row]);
    const uint32_t r1 = static_cast<uint32_t>(keys[2 * row + 1]);
    uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
    threefry2x32(r0, r1, a0, a1);
    threefry2x32(r0, r1, b0, b1);
    k0 = a0; k1 = a1;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      new_keys[2 * row] = static_cast<int32_t>(b0);
      new_keys[2 * row + 1] = static_cast<int32_t>(b1);
    }
    t = Elem<T>::round(fmaxf(temps[row], 1e-4f));
  } else {  // one key; counters run across rows (a single JAX draw)
    k0 = static_cast<uint32_t>(keys[0]);
    k1 = static_cast<uint32_t>(keys[1]);
    t = Elem<T>::round(temperature);
  }
  const T* lrow = logits + row * row_stride;
  unsigned long long mine = 0ull;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int v = base + i * kThreads;
    if (v < vocab) {
      const float x = Elem<T>::load(lrow + v);
      float score = x;
      if (!is_greedy) {
        const unsigned long long idx =
            split ? static_cast<unsigned long long>(v)
                  : static_cast<unsigned long long>(row) * vocab + v;
        uint32_t c0 = static_cast<uint32_t>(idx >> 32);
        uint32_t c1 = static_cast<uint32_t>(idx);
        threefry2x32(k0, k1, c0, c1);
        const float g = Elem<T>::gumbel(c0 ^ c1);
        const float scaled = Elem<T>::round(__fdiv_rn(x, t));
        score = Elem<T>::round(__fadd_rn(g, scaled));
      }
      if (scores != nullptr)
        scores[row * static_cast<long long>(vocab) + v] = score;
      const unsigned long long p = pack(score, static_cast<uint32_t>(v));
      mine = p > mine ? p : mine;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, mine, off);
    mine = o > mine ? o : mine;
  }
  __shared__ unsigned long long warp_best[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      mine = warp_best[w] > mine ? warp_best[w] : mine;
    atomicMax(best + row, mine);
    __threadfence();
    if (atomicAdd(ticket + row, 1u) == gridDim.x - 1) {  // the row's last
      __threadfence();
      const unsigned long long won = atomicExch(best + row, 0ull);
      atomicExch(ticket + row, 0u);
      tok[row] = static_cast<int32_t>(
          0xFFFFFFFFu - static_cast<uint32_t>(won & 0xFFFFFFFFull));
    }
  }
}

template <typename T>
int launch(const void* logits, long long row_stride, int rows, int vocab,
           const float* temps, const uint8_t* greedy, const int32_t* keys,
           int32_t* new_keys, int32_t* tok, unsigned long long* best,
           unsigned int* ticket, float* scores, int split, float temperature,
           cudaStream_t stream) {
  const dim3 grid((vocab + kTile - 1) / kTile, rows);
  sample_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), row_stride, vocab, temps, greedy, keys,
      new_keys, tok, best, ticket, scores, split, temperature);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [rows, vocab] (unit stride along vocab, row_stride between rows),
// dtype 0 float32 / 1 bfloat16. split = 1: keys [rows, 2] split in-kernel,
// new keys [rows, 2] written, temps [rows] and greedy [rows] (bool bytes)
// per row. split = 0: keys [2] one key over the flat [rows, vocab]
// counters, temperature for every row, greedy null, new_keys unused. best
// [rows] u64 and ticket [rows] u32: zero on entry, zero on return. scores
// (nullable) [rows, vocab] float32: each element's score, as it was ranked.
extern "C" int sample_rows(const void* logits, long long row_stride, int rows,
                           int vocab, const float* temps,
                           const uint8_t* greedy, const int32_t* keys,
                           int32_t* new_keys, int32_t* tok,
                           unsigned long long* best, unsigned int* ticket,
                           float* scores, int dtype, int split,
                           float temperature, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(logits, row_stride, rows, vocab, temps, greedy, keys,
                         new_keys, tok, best, ticket, scores, split,
                         temperature, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, row_stride, rows, vocab, temps,
                                 greedy, keys, new_keys, tok, best, ticket,
                                 scores, split, temperature, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
