// The Mamba-2 SSD chunked scan (B8) on Hopper's tensor cores, bf16 at
// chunk L 256, head dim P 64, state N 128 (mamba2-370m), and the pieces
// both B8 bodies share. ssd_chunk.cu holds the CUDA-core body (fp32 and the
// smoke shapes) and the C entry point, which routes between the two.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk.py:ssd_chunk
// and computes what ssd_chunk.cu's header says: per (batch row, head), chunk
// after chunk, y = intra (C·Bᵀ)·decay·dt·x + exp(cum)·(C·stateᵀ) with the
// state before the chunk's update, then state = exp(total)·state +
// xᵀ·(B∘w), w = exp(total − cum)·dt.
//
// What bounds it on the card: at the prefill shape (8 x 1024 tokens, 32
// heads) ~21.5 GFLOP of products against ~81 MB in and out, 0.02 ms either
// way; the CUDA-core body ran all four products as scalar fp32 FMAs out of
// shared memory (two shared loads a FMA) and took 180x that. Here every
// product is a bf16 wgmma with fp32 accumulators, and the loads stream
// under the products:
//   - one block per (head, batch row) of two consumer warpgroups and one
//     producer warpgroup (384 threads), walking the chunks in order. The
//     producer hands registers to the consumers (setmaxnreg 56 / 224): a
//     block of more than 8 warps gets 168 a thread at launch, under which
//     the consumers spill (and ran 15% slower). A chunk is
//     two steps: warpgroup 0 takes query tile 0 then 3, warpgroup 1 tile 1
//     then 2 (5 tile pairs each). The producer streams, in the order the
//     consumers take them, a query item (both warpgroups' 64-row C tiles)
//     per step into a 2-stage ring, and 64-row key tiles (B and x) into a
//     3-stage ring: keys 0-1 for the first step, 0-3 for the second, whose
//     pass also carries the state update. Each slot has a full and an empty
//     mbarrier. Copies are cp.async, 16 bytes a thread, into 128-byte-swizzled
//     tiles, zeros past S; B and C are addressed by their group through
//     element strides (the mixer hands them over as a stride-0 expand over
//     heads, which a TMA map cannot take). The producer signals an item
//     full once its copies have landed (wait_group 1 after issuing the next
//     one, then a proxy fence for wgmma's reads), so two items are in
//     flight while the consumers compute. ~200 KB of shared memory, one
//     block an SM; at no point is a whole chunk (160 KB) resident;
//   - per chunk the consumers scan dt (one thread a row, dt prefetched a
//     chunk ahead) into cum, then per step Y = C_q·stateᵀ (wgmma, the
//     state's bf16 copy, K-major) scaled by exp(cum_i); per key tile at or
//     below the diagonal S = C_q·B_kᵀ (m64n64k16 x 8), G = S·exp(cum_i −
//     cum_j)·dt_j in registers on the causal triangle and an exact 0 above
//     it (only differences are exponentiated: cum falls to ~-200 in a chunk,
//     exp(-cum) would overflow), G split into hi + lo bf16 terms as the
//     register A operands of Y += G·x_k (x read MN-major): one rounding of G
//     to bf16 costs y ~3e-3 of its rms, which 48 layers carry to the
//     logits. y is stored in bf16 for rows inside S;
//   - the state: each warpgroup owns 64 of its N columns as a wgmma
//     accumulator (fp32, 32 registers a thread) for the whole walk. In the
//     second step, per key tile: state += xᵀ·(B∘w) with xᵀ read MN-major
//     (the A transpose bit) and B∘w, which is not bf16-exact, split in two
//     bf16 terms hi = bf16(B∘w), lo = bf16(B∘w − hi), two wgmma chains
//     into the same accumulators (one rounding of B∘w would cost the state
//     ~1e-3 relative, past its 2e-4 tolerance), after state *= exp(total)
//     at the chunk's start. The warpgroup writes hi and lo into its own
//     scratch tiles in B's layout while its S product runs. The state's
//     bf16 copy (the next chunk's inter operand) alternates between two
//     buffers, so the chunk's scan barrier is the only block-wide wait.
// The one new rounding against the CUDA-core body is the state's operand
// copy to bf16 in the inter term (y ~1e-4 of its rms; y is bf16 itself).
// The split terms cost a second wgmma chain in G·x and in the update.
//
// Ragged S: L is a template constant; rows past S load as zeros and act as
// dt = 0 (decay 1, no input), and are not stored, so any S gives ssd_scan's
// result. Key tiles wholly past S are not streamed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "flash_tc.cuh"

namespace ssd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct SsdArgs {
  int seqlen, heads, heads_per_group;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dt_sb, dt_ss, dt_sh;
};

// Inclusive prefix sum over the kThreads threads 0..kThreads-1, one value
// per thread; they synchronise on barrier 1 alone, so other warps of the
// block (the tensor-core body's producer) may run on.
__device__ inline float block_inclusive_scan(float v, float* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) wtot[warp] = v;
  flash_tc::named_sync(1, kThreads);
  if (warp == 0) {
    float t = lane < kWarps ? wtot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    if (lane < kWarps) wtot[lane] = t;
  }
  flash_tc::named_sync(1, kThreads);
  if (warp > 0) v += wtot[warp - 1];
  return v;
}

}  // namespace ssd


namespace ssd_tc {

constexpr int kL = 256, kP = 64, kN = 128;
constexpr int kTile = 64;                 // rows of a query or key tile
constexpr int kTiles = kL / kTile;
constexpr int kHalf = kTile * 128;        // [64 rows][64] bf16: 8 KB
constexpr int kTileCB = 2 * kHalf;        // a C or B tile [64][128]
constexpr int kConsumers = 2 * 128;       // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread after the hand-over (the block has 384 x 168 at launch)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 384 * 168,
              "the register pool of one block");
constexpr int kQStages = 2, kKStages = 3;
constexpr int kQItem = 2 * kTileCB;       // both warpgroups' C tiles
constexpr int kKItem = kTileCB + kHalf;   // a key tile: B, then x
constexpr int kOffQ = 0;                  // shared-memory regions (bytes)
constexpr int kOffK = kOffQ + kQStages * kQItem;
constexpr int kOffS = kOffK + kKStages * kKItem;  // two bf16 state copies
constexpr int kOffT = kOffS + 2 * 2 * kHalf;      // hi / lo terms a warpgroup
constexpr int kOffF = kOffT + 2 * 2 * kHalf;      // dt, cum, w, scan partials
constexpr int kOffBar = kOffF + 4 * (3 * kL + ssd::kWarps);
constexpr int kSmem = kOffBar + 8 * 2 * (kQStages + kKStages) + 1024;
static_assert(kL == ssd::kThreads && kConsumers == ssd::kThreads,
              "one scan thread per chunk row");
static_assert(kP == 64 && kN == 2 * 64, "one wgmma M tile of P, two N halves");
static_assert(kSmem <= 227 * 1024, "shared memory of one block");

// byte offset of 16-byte chunk c (0-7) of row r in a [rows][64] bf16 region
// under the 128-byte swizzle (1024-byte aligned: row r % 8 of its atom)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// K-major operand (N or K contiguous in 64-wide halves), MN-major operand
// (64 rows of the reduced dimension, the other one contiguous)
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return flash_tc::sw128_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  return flash_tc::sw128_desc(addr, kHalf, 1024);
}

// the query tile warpgroup w takes in step 0 or 1 of a chunk: (0, 3) and
// (1, 2), 5 tile pairs each
__device__ __forceinline__ int q_tile(int step, int w) {
  return step == 0 ? w : kTiles - 1 - w;
}

// key tiles streamed in a step: those below its query tiles' diagonal
// (0-1, then 0-3), and only tiles holding a row inside S
__device__ __forceinline__ int step_keys(int step, int tiles) {
  return step == 0 ? min(2, tiles) : tiles;
}

// 8 bf16 values times w, as bf16 hi and lo terms with hi + lo = v·w to
// about 2^-16 relative
__device__ __forceinline__ void split_scaled(const uint4& raw, float w,
                                             uint4& hi, uint4& lo) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v0 = __uint_as_float(in[i] << 16) * w;
    const float v1 = __uint_as_float(in[i] & 0xffff0000u) * w;
    h[i] = flash_tc::pack_bf16(v0, v1);
    const float h0 = __uint_as_float(h[i] << 16);
    const float h1 = __uint_as_float(h[i] & 0xffff0000u);
    l[i] = flash_tc::pack_bf16(v0 - h0, v1 - h1);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ bm,
                        const __nv_bfloat16* __restrict__ cm,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ state_out,
                        const ssd::SsdArgs args) {
  using namespace flash_tc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  uint8_t* gen = smem_raw + (base - raw);       // the same bytes, generic
  float* dts = reinterpret_cast<float*>(gen + kOffF);  // [L] dt, 0 past S
  float* cum = dts + kL;  // [L] inclusive prefix sum of dt·A
  float* win = cum + kL;  // [L] exp(total − cum)·dt
  float* wtot = win + kL;
  // full / empty barriers of the query slots, then of the key slots
  const uint32_t q_full = base + kOffBar, q_empty = q_full + 8 * kQStages;
  const uint32_t k_full = q_empty + 8 * kQStages,
                 k_empty = k_full + 8 * kKStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int grp = h / args.heads_per_group;
  const int seqlen = args.seqlen;
  const int n_chunks = (seqlen + kL - 1) / kL;

  if (tid == 0) {
    for (int i = 0; i < kQStages; ++i) {
      mbar_init(q_full + 8 * i, 128);  // the producer's threads
      mbar_init(q_empty + 8 * i, kConsumers);
    }
    for (int i = 0; i < kKStages; ++i) {
      mbar_init(k_full + 8 * i, 128);
      mbar_init(k_empty + 8 * i, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index broadcast from lane 0, so the compiler sees it (and
  // the tile loops it bounds) uniform over each warp: wgmma under a branch
  // it thinks divergent gets serialising warpgroup barriers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wtid = tid % 128;
  if (wg == 2) {
    // ---- the producer warpgroup: every item the consumers take, in their
    //      order, 16 bytes a thread
    setmaxnreg_dec<kProducerRegs>();
    const __nv_bfloat16* xb = x + bb * args.x_sb + h * args.x_sh;
    const __nv_bfloat16* bgb = bm + bb * args.b_sb + grp * args.b_sg;
    const __nv_bfloat16* cgb = cm + bb * args.c_sb + grp * args.c_sg;
    uint32_t landing = 0;  // the full barrier of the last item issued
    // after committing an item: the one before it has landed; make its
    // bytes visible to wgmma (the async proxy), then mark it full
    auto mark_previous_full = [&landing]() {
      cp_async_wait<1>();
      fence_proxy_async();
      if (landing) mbar_arrive(landing);
    };
    int qi = 0, ki = 0;  // items issued into each ring
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int r0 = ch * kL, rows = min(kL, seqlen - r0);
      const int tiles = (rows + kTile - 1) / kTile;
      for (int step = 0; step < 2; ++step) {
        const int qs = qi % kQStages;
        mbar_wait(q_empty + 8 * qs, ((qi / kQStages) & 1) ^ 1);
        const uint32_t dst = base + kOffQ + qs * kQItem;
        for (int e = wtid; e < 2 * kTile * 16; e += 128) {
          const int w = e / (kTile * 16), r = e / 16 % kTile, c = e % 16;
          const int row = q_tile(step, w) * kTile + r;
          const bool ok = row < rows;
          cp_async_16(dst + w * kTileCB + (c / 8) * kHalf + swz(r, c % 8),
                      cgb + (ok ? r0 + row : 0) * args.c_ss + 8 * c, ok);
        }
        cp_async_commit();
        mark_previous_full();
        landing = q_full + 8 * qs;
        ++qi;
        for (int kt = 0; kt < step_keys(step, tiles); ++kt) {
          const int ks = ki % kKStages;
          mbar_wait(k_empty + 8 * ks, ((ki / kKStages) & 1) ^ 1);
          const uint32_t kb = base + kOffK + ks * kKItem;
          for (int e = wtid; e < kTile * 16; e += 128) {
            const int r = e / 16, c = e % 16, row = kt * kTile + r;
            const bool ok = row < rows;
            cp_async_16(kb + (c / 8) * kHalf + swz(r, c % 8),
                        bgb + (ok ? r0 + row : 0) * args.b_ss + 8 * c, ok);
          }
          for (int e = wtid; e < kTile * 8; e += 128) {
            const int r = e / 8, c = e % 8, row = kt * kTile + r;
            const bool ok = row < rows;
            cp_async_16(kb + kTileCB + swz(r, c),
                        xb + (ok ? r0 + row : 0) * args.x_ss + 8 * c, ok);
          }
          cp_async_commit();
          mark_previous_full();
          landing = k_full + 8 * ks;
          ++ki;
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    if (landing) mbar_arrive(landing);
    return;
  }

  // ---- the two consumer warpgroups
  setmaxnreg_inc<kConsumerRegs>();
  // this thread's fragment rows (prow, prow + 8) and columns 8 i + 2 t (+1)
  const int prow = 16 * (warp % 4) + lane / 4, t = lane % 4;
  const float A = a[h];
  const float* dtb = dt + bb * args.dt_sb + h * args.dt_sh;
  const long long y_ss = static_cast<long long>(args.heads) * kP;
  __nv_bfloat16* yb = y + (static_cast<long long>(bb) * seqlen * args.heads + h) * kP;
  const uint32_t terms = base + kOffT + wg * 2 * kHalf;  // hi, then lo

  for (int i = tid; i < 2 * kHalf / 16; i += kConsumers)
    *reinterpret_cast<uint4*>(gen + kOffS + 16 * i) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();  // the chunk's scan barrier publishes it
  float st[32];  // state rows prow (+8), columns 64 wg + 8 i + 2 t (+1)
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;

  float d_next = tid < seqlen ? dtb[tid * args.dt_ss] : 0.f;
  int qi = 0, ki = 0;  // items taken from each ring
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * kL;
    const int rows = min(kL, seqlen - r0);
    const int tiles = (rows + kTile - 1) / kTile;  // tiles holding a real row
    // 1. dt and the cumulative log-decay (the next chunk's dt on its way)
    const float d = d_next;
    d_next = r0 + kL + tid < seqlen ? dtb[(r0 + kL + tid) * args.dt_ss] : 0.f;
    const float v = ssd::block_inclusive_scan(d * A, wtot);
    dts[tid] = d;
    cum[tid] = v;
    named_sync(1, kConsumers);
    const float total = cum[kL - 1];
    win[tid] = expf(total - v) * d;
    named_sync(1, kConsumers);  // also: the state's copy below is written
    const uint32_t s_s = base + kOffS + (ch & 1) * 2 * kHalf;
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] *= decay;

#pragma unroll 1
    for (int step = 0; step < 2; ++step) {
      const int qt = q_tile(step, wg);
      const bool active = qt < tiles;  // uniform over the warpgroup
      const int qs = qi % kQStages;
      mbar_wait(q_full + 8 * qs, (qi / kQStages) & 1);
      const uint32_t cq = base + kOffQ + qs * kQItem + wg * kTileCB;
      const int ra = qt * kTile + prow, rb = ra + 8;  // chunk rows
      const float ca = cum[ra], cb = cum[rb];
      float yacc[32], s[32];
      uint32_t pa[16], pl[16];  // G's hi and lo bf16 terms
      if (active) {
        // inter-chunk term from the state before this chunk's update
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
          wgmma_ss(yacc, k_major(cq + off), k_major(s_s + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(yacc);
        const float ea = __expf(ca), eb = __expf(cb);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          yacc[4 * i] *= ea;
          yacc[4 * i + 1] *= ea;
          yacc[4 * i + 2] *= eb;
          yacc[4 * i + 3] *= eb;
        }
      }
#pragma unroll 1
      for (int kt = 0; kt < step_keys(step, tiles); ++kt) {
        const int ks = ki % kKStages;
        mbar_wait(k_full + 8 * ks, (ki / kKStages) & 1);
        const uint32_t bk = base + kOffK + ks * kKItem, xk = bk + kTileCB;
        const bool pair = active && kt <= qt;  // uniform over the warpgroup
        const bool update = step == 1;
        if (pair) {  // S = C_q B_kᵀ, running while the terms are written
          fence_operands(s);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
            wgmma_ss(s, k_major(cq + off), k_major(bk + off), kk > 0);
          }
          wgmma_commit();
        }
        if (update) {
          // this warpgroup's 64 columns of B_k∘w as hi + lo terms
          named_sync(2 + wg, 128);  // the last key's terms are read
          for (int e = wtid; e < kHalf / 16; e += 128) {
            const int o = e * 16;
            const uint4 bv = *reinterpret_cast<const uint4*>(
                gen + (bk - base) + wg * kHalf + o);
            uint4 hi, lo;
            split_scaled(bv, win[kt * kTile + o / 128], hi, lo);
            uint8_t* dst = gen + (terms - base) + o;
            *reinterpret_cast<uint4*>(dst) = hi;
            *reinterpret_cast<uint4*>(dst + kHalf) = lo;
          }
          fence_proxy_async();
          named_sync(2 + wg, 128);
        }
        if (pair) {
          wgmma_wait<0>();
          fence_operands(s);
          // G on the causal triangle, an exact 0 above it, as hi + lo bf16
          // terms (one rounding of G costs y ~3e-3 of its rms)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int j0 = kt * kTile + 8 * i + 2 * t;
            const float2 cj = *reinterpret_cast<const float2*>(cum + j0);
            const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
            const float g00 = j0 <= ra ? s[4 * i] * __expf(ca - cj.x) * dj.x : 0.f;
            const float g01 = j0 < ra ? s[4 * i + 1] * __expf(ca - cj.y) * dj.y : 0.f;
            const float g10 = j0 <= rb ? s[4 * i + 2] * __expf(cb - cj.x) * dj.x : 0.f;
            const float g11 = j0 < rb ? s[4 * i + 3] * __expf(cb - cj.y) * dj.y : 0.f;
            pa[2 * i] = pack_bf16(g00, g01);      // row ra
            pa[2 * i + 1] = pack_bf16(g10, g11);  // row rb
            pl[2 * i] = pack_bf16(g00 - __uint_as_float(pa[2 * i] << 16),
                                  g01 - __uint_as_float(pa[2 * i] & 0xffff0000u));
            pl[2 * i + 1] =
                pack_bf16(g10 - __uint_as_float(pa[2 * i + 1] << 16),
                          g11 - __uint_as_float(pa[2 * i + 1] & 0xffff0000u));
          }
          fence_operands(yacc);
        }
        if (pair || update) {
          fence_operands(st);
          wgmma_fence();
          if (pair) {
            // Y += G x_k: 4 k-steps of 16 keys, G's k-step kk is pa/pl[4 kk ..]
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t xd = mn_major(xk + kk * 16 * 128);
              const uint32_t hi[4] = {pa[4 * kk], pa[4 * kk + 1],
                                      pa[4 * kk + 2], pa[4 * kk + 3]};
              const uint32_t lo[4] = {pl[4 * kk], pl[4 * kk + 1],
                                      pl[4 * kk + 2], pl[4 * kk + 3]};
              wgmma_rs(yacc, hi, xd);
              wgmma_rs(yacc, lo, xd);
            }
          }
          if (update) {
            // st += x_kᵀ (hi + lo), xᵀ and the terms MN-major
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t xa = mn_major(xk + kk * 16 * 128);
              wgmma_ss<1, 1>(st, xa, mn_major(terms + kk * 16 * 128), 1);
              wgmma_ss<1, 1>(st, xa, mn_major(terms + kHalf + kk * 16 * 128), 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(yacc);
          fence_operands(st);
        }
        mbar_arrive(k_empty + 8 * ks);  // this warpgroup is done with B_k, x_k
        ++ki;
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * i + 2 * t;
          if (ra < rows)
            *reinterpret_cast<uint32_t*>(yb + (r0 + ra) * y_ss + col) =
                pack_bf16(yacc[4 * i], yacc[4 * i + 1]);
          if (rb < rows)
            *reinterpret_cast<uint32_t*>(yb + (r0 + rb) * y_ss + col) =
                pack_bf16(yacc[4 * i + 2], yacc[4 * i + 3]);
        }
      }
      mbar_arrive(q_empty + 8 * qs);
      ++qi;
    }

    // 2. the new state's bf16 copy, this warpgroup's K-major half, into the
    //    other buffer (the next chunk's scan barrier publishes it; the
    //    buffer's last readers were in the previous chunk)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * t;
      uint8_t* half =
          gen + kOffS + ((ch + 1) & 1) * 2 * kHalf + wg * kHalf + (c % 8) * 2;
      *reinterpret_cast<uint32_t*>(half + swz(prow, c / 8)) =
          pack_bf16(st[4 * i], st[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(half + swz(prow + 8, c / 8)) =
          pack_bf16(st[4 * i + 2], st[4 * i + 3]);
    }
    fence_proxy_async();
  }

  float* so = state_out + (static_cast<long long>(bb) * args.heads + h) * kP * kN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 64 * wg + 8 * i + 2 * t;
    *reinterpret_cast<float2*>(so + prow * kN + c) = make_float2(st[4 * i], st[4 * i + 1]);
    *reinterpret_cast<float2*>(so + (prow + 8) * kN + c) =
        make_float2(st[4 * i + 2], st[4 * i + 3]);
  }
}

// The tensor-core body needs every row it copies 16-byte aligned: x, b, c
// at 16-byte addresses and their (batch, sequence, head/group) strides a
// multiple of 8 elements.
inline bool aligned(const void* x, const void* b, const void* c,
                    const ssd::SsdArgs& a) {
  for (const void* p : {x, b, c})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long long s : {a.x_sb, a.x_ss, a.x_sh, a.b_sb, a.b_ss, a.b_sg, a.c_sb,
                      a.c_ss, a.c_sg})
    if (s % 8 != 0) return false;
  return true;
}

inline cudaError_t launch(const void* x, const void* b, const void* c,
                          const float* dt, const float* a, void* y,
                          float* state, int batch, const ssd::SsdArgs& args,
                          cudaStream_t s) {
  if (!aligned(x, b, c, args)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  ssd_chunk_tc_kernel<<<dim3(args.heads, batch), kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), dt, a,
      static_cast<__nv_bfloat16*>(y), state, args);
  return cudaGetLastError();
}

}  // namespace ssd_tc
