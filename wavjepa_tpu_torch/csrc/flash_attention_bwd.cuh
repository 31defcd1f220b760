// Masked self-attention backward for Hopper (sm_90a): dq, dk, dv of
// flash_attention_fwd.cuh, recomputing the probabilities from q, k and the
// forward's row statistics instead of storing them.
//
// Replaces the TPU kernel wavjepa_tpu/ops/flash_attention.py:_bwd_kernel
// (launched by _bwd through pl.pallas_call). Per (batch, head), with
// s = d^-1/2 · q kᵀ in f32 and masked keys at the finite f32 minimum:
//     P  = softmax(s)                       f32, rebuilt as exp(s − m) / l
//     dV = P_loᵀ dO                         P_lo = P rounded to the input type
//     dP = dO Vᵀ                            f32
//     dS = P ⊙ (dP − rowsum(dP ⊙ P))        f32, no zeroing at masked keys
//     dQ = d^-1/2 · dS_lo K,  dK = d^-1/2 · dS_loᵀ Q
// with q, k, v, dO, dq, dk, dv of shape (B, H, T, d) in bf16 or f32 (each
// addressed through HeadStrides, attention_common.cuh), the
// mask (B, T) bytes (true = ignore that key) and (m, l) per query row from
// the forward, (B, H, T, 2) f32. A fully masked row keeps the TPU kernel's
// maths: its P is uniform, so its dS is not zero and dq, dk get its share.
// A slot past T in a ragged last tile is neither a key nor a query: it gets
// weight 0 and contributes nothing.
//
// What bounds it on an H100. The five T×T×d products of the maths (the
// recomputed Q Kᵀ, then dO Vᵀ, P_loᵀ dO, dS_lo K, dS_loᵀ Q) are about
// 10·B·H·T²·d operations; the bytes are q, k, v and dO read once, dq, dk,
// dv written once (about 7·B·H·T·d elements), plus the mask and the row
// statistics: about 0.7·T operations a byte in bf16. At the training shapes
// (T = 88 in the packed student encoder, T = 128 in the packed decoder) that
// is 63 and 91, far below the ~295 at which the tensor cores become the
// limit: the bound is the bytes (about 72 µs at (256, 12, 88, 64) and 210 µs
// at (1024, 12, 128, 32) at the data sheet's 3.35 TB/s, against 15 and 65 µs
// of operations at 989 TFLOP/s). So the design reads each input once, keeps
// the loads in flight under the products, and does the five products only.
//
// Two routes for bf16, chosen in one place (route(), below) for both callers:
//   * T ≤ kSinglePassMaxT = 128 (every training shape of the AudioSet
//     configuration: 88, 100, 128): one block per (batch, head), no atomics
//     and no second pass. Persistent blocks, one an SM; one producer thread
//     loads the next (batch, head)'s q, k, v, dO (TMA, rank-4 tensor maps
//     as in the forward, zeros past T) and mask bytes into the second of two
//     slots while the consumers work on the first, and the consumers load
//     their rows' (m, l) one (batch, head) ahead. KT/64 consumer
//     warpgroups (KT = 64 or 128 rows and keys, T padded up) own 64 query
//     rows each and all keys:
//       1. S = Q·Kᵀ and dP = dO·Vᵀ as wgmma with both operands in shared
//          memory (N = KT keys);
//       2. P = 2^(s·scale·log2(e) − m·log2(e)) / l, as the forward takes it,
//          D = rowsum(dP ⊙ P) over the lanes of a row, dS, in registers, in
//          the order of the TPU kernel's maths;
//       3. P_lo and dS_lo into shared memory, 128-byte swizzled in 64-key
//          column blocks;
//       4. dQ = dS_lo·K with dS_lo from registers and K read MN-major; after a
//          barrier over the consumers, dV = P_loᵀ·dO and dK = dS_loᵀ·Q over
//          the warpgroup's 64 keys, P_lo, dS_lo, dO and Q all read MN-major
//          through the transpose bits;
//       5. dq, dk, dv rounded into the slot's Q, K and V tiles (read for the
//          last time) and stored by TMA, which drops rows past T; the slot
//          goes back to the producer once the stores have read it.
//     Every sum runs in a fixed order, so two calls give equal bits. The
//     threshold is where this stops fitting: at KT = 128 a consumer holds
//     S and dP (128 f32 registers of its 232) and the block 2 × 64 KB of
//     input slots (d = 64) beside 64 KB of P_lo and dS_lo; at KT = 192 the
//     two accumulators alone take 192 registers and P_lo, dS_lo 144 KB.
//   * T > 128 (the unpacked 200-token encoder, which train/config.py's
//     packing options reach): two deterministic passes of 64-row blocks with
//     mma.sync m16n8k16, each walking the other side in tiles of 64:
//       1. one block per (query block, head, batch) makes dQ. Its first sweep
//          over the keys sums D = rowsum(dP ⊙ P) exactly as the TPU kernel
//          does (rowsum(dO ⊙ O) would differ by the forward's bf16 rounding
//          of P and O), and writes D to the caller's scratch `dsum`; its
//          second sweep forms dS and dQ.
//       2. one block per (key block, head, batch) makes dK and dV, walking
//          the query tiles with their (m, l, D).
//     They re-read q, k, v, dO once per 64-row block and recompute Q Kᵀ and
//     dO Vᵀ three times in all (nine products instead of five). Tiles read
//     as B with k along the row are staged row-major, those read with k down
//     the column transposed; each staged row is padded by 8 values so that
//     fragment loads hit 32 distinct banks.
// f32 (parity checks) runs the two passes with 256 threads of CUDA-core
// FMAs, 4×4 of each 64×64 tile a thread, products through shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace wavjepa {
namespace flash_bwd {

constexpr int kBlock = 64;  // rows a block owns, and rows of a tile it walks
constexpr int kPad = 8;     // bf16 values of padding at the end of a staged row

using namespace hopper;

// ------------------------------------- bf16, one block per (batch, head), wgmma

constexpr int kSinglePassMaxT = 128;  // the largest T of the single-pass kernel

// Shared memory of a block, from a 1024-aligned base: two input slots of
// q, k, v, dO (KT rows each, TMA's swizzle), P_lo and dS_lo (KT/64 blocks
// of 64 keys × KT query rows, 128-byte swizzled), each slot's mask bytes,
// then the slots' full and empty barriers.
template <int D, int KT>
struct Smem {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kTile = KT * kRowBytes;  // one of q, k, v, dO
  static constexpr int kSlot = 4 * kTile;
  static constexpr int kP = 2 * kSlot;
  static constexpr int kDS = kP + KT * KT * 2;
  // per slot, the KT mask bytes from the 16-byte boundary at or before the
  // row's first (TMA loads from aligned addresses and writes 128-aligned)
  static constexpr int kMaskBox = KT + 16;
  static constexpr int kMask = kDS + KT * KT * 2;
  static constexpr int kBars = kMask + 2 * 256;
  static constexpr int kBytes = kBars + 4 * 8 + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// KT = 64 or 128: rows and keys of a (batch, head), T padded up; KT/64
// consumer warpgroups after the producer's. Maps: q, k, v, dO in boxes of
// KT rows, dq, dk, dv in boxes of 64.
template <int D, int KT>
__global__ void __launch_bounds__(128 * (1 + KT / 64), 1)
bwd_single_pass_bf16(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dq,
                     const __grid_constant__ CUtensorMap map_dk,
                     const __grid_constant__ CUtensorMap map_dv,
                     const __grid_constant__ CUtensorMap map_mask,
                     const float* __restrict__ stats, int H, int seq, float scale, int items) {
  using L = Smem<D, KT>;
  constexpr int W = 2 * D;        // bytes of a q, k, v or dO row
  constexpr int NW = KT / 64;     // consumer warpgroups
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint8_t* const smem = smem_raw + (base - smem_addr(smem_raw));  // generic view of base
  const uint8_t* const mask_smem = smem + L::kMask;
  const uint32_t full = base + L::kBars, empty = full + 16;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(full + 8 * i, 1);   // the producer's expect_tx, then the bytes
      bar_init(empty + 8 * i, NW); // each consumer warpgroup once its stores have read
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    // one thread: q, k, v, dO of each (batch, head) and its mask bytes
    // (which may run past T into the next row's: the consumers look at the
    // key index first)
    int slot = 0, phase = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int h = t % H, b = t / H;
      bar_wait(empty + 8 * slot, phase ^ 1);  // the first pass finds both free
      const uint32_t bar = full + 8 * slot, in = base + slot * L::kSlot;
      bar_expect_tx(bar, L::kSlot + L::kMaskBox);
      tma_load_4d(in, &map_q, bar, 0, 0, h, b);
      tma_load_4d(in + L::kTile, &map_k, bar, 0, 0, h, b);
      tma_load_4d(in + 2 * L::kTile, &map_v, bar, 0, 0, h, b);
      tma_load_4d(in + 3 * L::kTile, &map_do, bar, 0, 0, h, b);
      tma_load_1d(base + L::kMask + slot * 256, &map_mask, bar, (b * seq) & ~15);
      if (++slot == 2) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = wg - 1;  // query rows and keys 64w .. 64w + 63
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, c = lane % 4;
  const int r = 64 * w + 16 * warp + g;  // this lane's query rows r and r + 8
  const bool row_in[2] = {r < seq, r + 8 < seq};
  // the (m, l) of rows r and r + 8 of item t, loaded one item ahead
  const float2* const stats2 = reinterpret_cast<const float2*>(stats);
  float2 st_next[2];
  auto load_stats = [&](int t) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      st_next[e] = t < items && row_in[e] ? stats2[(size_t)t * seq + r + 8 * e] : make_float2(0.f, 1.f);
  };
  load_stats(blockIdx.x);
  int slot = 0, phase = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int h = t % H, b = t / H;
    const float2 st_cur[2] = {st_next[0], st_next[1]};
    load_stats(t + gridDim.x);
    const uint32_t q_t = base + slot * L::kSlot, k_t = q_t + L::kTile;
    const uint32_t v_t = k_t + L::kTile, do_t = v_t + L::kTile;
    bar_wait(full + 8 * slot, phase);

    // 1. S = Q Kᵀ and dP = dO Vᵀ for the warpgroup's 64 rows, all KT keys
    float s[KT / 2], dp[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
    keep(s);
    keep(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma<KT, 0, 0>(s, k_major<W>(q_t + 64 * w * W, ks), k_major<W>(k_t, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma<KT, 0, 0>(dp, k_major<W>(do_t + 64 * w * W, ks), k_major<W>(v_t, ks));
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    keep(dp);

    // 2. P = exp(s − m)/l (0 past T), D = rowsum(dP ⊙ P), dS = P ⊙ (dP − D):
    // key 8·(i/4) + 2c + (i & 1) holds s[i] of rows r ((i >> 1) & 1 = 0), r + 8
    // in the log2 domain, as the forward: a fully masked row's max is the
    // sentinel itself, so that its masked keys get 2^0
    float m2[2], inv_l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m2[e] = st_cur[e].x == -FLT_MAX ? -FLT_MAX : st_cur[e].x * kLog2e;
      inv_l[e] = 1.f / st_cur[e].y;
    }
    const float scale2 = scale * kLog2e;
    const uint8_t* ms = mask_smem + slot * 256 + ((b * seq) & 15);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < KT / 2; i += 4) {
      const int col = 8 * (i / 4) + 2 * c;
      const float b0 = key_bias(col, seq, ms[col]), b1 = key_bias(col + 1, seq, ms[col + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const float x = fmaf(s[i + e], scale2, e & 1 ? b1 : b0);
        const float p = row_in[row] ? exp2_fast(x - m2[row]) * inv_l[row] : 0.f;
        s[i + e] = p;
        part[row] += p * dp[i + e];
      }
    }
    const float drow[2] = {quad_sum(part[0]), quad_sum(part[1])};
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) dp[i] = s[i] * (dp[i] - drow[(i >> 1) & 1]);

    // 3. P_lo and dS_lo into shared memory: key column block j/8, unit j%8
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const uint32_t at = (j / 8) * (KT * 128) + swizzled<128>(r, j % 8) + 4 * c;
      const uint32_t at8 = (j / 8) * (KT * 128) + swizzled<128>(r + 8, j % 8) + 4 * c;
      st_shared(base + L::kP + at, pack_bf16x2(s[4 * j], s[4 * j + 1]));
      st_shared(base + L::kP + at8, pack_bf16x2(s[4 * j + 2], s[4 * j + 3]));
      st_shared(base + L::kDS + at, pack_bf16x2(dp[4 * j], dp[4 * j + 1]));
      st_shared(base + L::kDS + at8, pack_bf16x2(dp[4 * j + 2], dp[4 * j + 3]));
    }

    // 4. dQ = dS_lo K (dS_lo from registers, K MN-major) ...
    uint32_t dsa[KT / 16][4];
    hopper::pack_a<KT>(dsa, dp);  // not the two-pass kernel's pack_a below
    float dq[D / 2], dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = dk[i] = dv[i] = 0.f;
    keep(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs<D, 1>(dq, dsa[kk], mn_major<W>(k_t, kk));
    wgmma_commit();
    // ... then, with every row's P_lo and dS_lo in place, dV = P_loᵀ dO and
    // dK = dS_loᵀ Q over this warpgroup's 64 keys (A and B MN-major)
    fence_async_shared();
    named_sync(1, 128 * NW);
    keep(dk);
    keep(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma<D, 1, 1>(dv, mn_major<128>(base + L::kP + w * KT * 128, kk), mn_major<W>(do_t, kk));
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma<D, 1, 1>(dk, mn_major<128>(base + L::kDS + w * KT * 128, kk), mn_major<W>(q_t, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(dq);
    keep(dk);
    keep(dv);
    keep(dsa);

    // 5. every warpgroup is done with the slot: dq, dk, dv rounded into its
    // q, k, v tiles (rows 64w ..) and stored by TMA
    named_sync(1, 128 * NW);
    const int lr = 16 * warp + g;  // row of the 64-row output tile
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {
      const uint32_t at = 64 * w * W + swizzled<W>(lr, u) + 4 * c;
      const uint32_t at8 = 64 * w * W + swizzled<W>(lr + 8, u) + 4 * c;
      st_shared(q_t + at, pack_bf16x2(dq[4 * u] * scale, dq[4 * u + 1] * scale));
      st_shared(q_t + at8, pack_bf16x2(dq[4 * u + 2] * scale, dq[4 * u + 3] * scale));
      st_shared(k_t + at, pack_bf16x2(dk[4 * u] * scale, dk[4 * u + 1] * scale));
      st_shared(k_t + at8, pack_bf16x2(dk[4 * u + 2] * scale, dk[4 * u + 3] * scale));
      st_shared(v_t + at, pack_bf16x2(dv[4 * u], dv[4 * u + 1]));
      st_shared(v_t + at8, pack_bf16x2(dv[4 * u + 2], dv[4 * u + 3]));
    }
    fence_async_shared();
    named_sync(2 + w, 128);
    if (threadIdx.x % 128 == 0) {
      if (64 * w < seq) {
        tma_store_4d(&map_dq, q_t + 64 * w * W, 0, 64 * w, h, b);
        tma_store_4d(&map_dk, k_t + 64 * w * W, 0, 64 * w, h, b);
        tma_store_4d(&map_dv, v_t + 64 * w * W, 0, 64 * w, h, b);
        bulk_commit();
        bulk_wait<true>();
      }
      bar_arrive(empty + 8 * slot);
    }
    if (++slot == 2) {
      slot = 0;
      phase ^= 1;
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<false>();
}

// ---------------------------------------------------- bf16, two passes, mma.sync

constexpr int kMmaThreads = (kBlock / 16) * 32;  // one warp per 16 rows
constexpr int kNTiles = kBlock / 8;               // 8-wide C tiles across a tile

// Copy rows r0 .. r0+63 of a row-major bf16 matrix of D columns (rows ld
// apart) into shared memory, row-major into `rows` (stride D + kPad) and,
// when `cols` is not null, transposed into `cols` (stride kBlock + kPad).
// Rows past T are zero.
template <int D>
__device__ __forceinline__ void stage(const __nv_bfloat16* src, int ld, int r0, int seq,
                                      __nv_bfloat16* rows, __nv_bfloat16* cols) {
  constexpr int kChunks = kBlock * D / 8;  // 16-byte chunks of a tile
  src += (size_t)r0 * ld;  // in-tile offsets fit an int
  for (int i = threadIdx.x; i < kChunks; i += kMmaThreads) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq) x = *reinterpret_cast<const uint4*>(src + (r * ld + col));
    *reinterpret_cast<uint4*>(&rows[r * (D + kPad) + col]) = x;
    if (cols != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(col + j) * (kBlock + kPad) + r] = e[j];
    }
  }
}

// C (16 × 64) = A (16 × D) · Bᵀ for a row-major staged tile B (64 × D).
template <int D>
__device__ __forceinline__ void product_rows(float (&acc)[kNTiles][4],
                                             const uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16* tile, int g, int c) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const __nv_bfloat16* p = &tile[(nt * 8 + g) * (D + kPad) + ks * 16 + 2 * c];
      mma_16x8x16(acc[nt], a[ks], load_u32(p), load_u32(p + 8));
    }
  }
}

// C (16 × D) += A (16 × 64) · B for a tile B (64 × D) staged transposed.
template <int D>
__device__ __forceinline__ void product_cols(float (&acc)[D / 8][4],
                                             const uint32_t (&a)[kBlock / 16][4],
                                             const __nv_bfloat16* tile_t, int g, int c) {
#pragma unroll
  for (int j = 0; j < kBlock / 16; ++j) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* p = &tile_t[(dt * 8 + g) * (kBlock + kPad) + j * 16 + 2 * c];
      mma_16x8x16(acc[dt], a[j], load_u32(p), load_u32(p + 8));
    }
  }
}

// C tiles 2j and 2j+1 of a 16 × 64 f32 product, rounded to bf16, are the A
// fragment of columns 16j .. 16j+15 for the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[kBlock / 16][4], int nt, const float (&x)[4]) {
  a[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(x[0], x[1]);
  a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(x[2], x[3]);
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int ld, const float (&acc)[D / 8][4],
                                           int row0, bool in0, bool in1, float mul, int c) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * c;
    if (in0)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * ld + col) =
          pack_bf16x2(acc[dt][0] * mul, acc[dt][1] * mul);
    if (in1)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + 8) * ld + col) =
          pack_bf16x2(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

// Pass 1: dQ, and D = rowsum(dP ⊙ P) for pass 2.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
            float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int H, int seq,
            float scale, HeadStrides in, HeadStrides out) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlock * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 Kt[D * (kBlock + kPad)];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlock * (D + kPad)];
  __shared__ uint8_t Ms[kBlock];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = blockIdx.x * kBlock + (tid >> 5) * 16 + g;  // and row0 + 8
  const size_t rows = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)seq;
  const size_t head = in.at(blockIdx.z, blockIdx.y), ohead = out.at(blockIdx.z, blockIdx.y);
  const uint8_t* mrow = mask + (size_t)blockIdx.z * seq;
  const bool row_in[2] = {row0 < seq, row0 + 8 < seq};

  uint32_t qa[D / 16][4], da[D / 16][4];  // the warp's rows of Q and dO
  load_a_rows<D>(qa, q + head, in.row, row0, row_in[0], row_in[1], c);
  load_a_rows<D>(da, dout + ohead, out.row, row0, row_in[0], row_in[1], c);
  float m[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row_in[i]) {
      const float2 st = *reinterpret_cast<const float2*>(stats + 2 * (rows + row0 + 8 * i));
      m[i] = st.x;
      inv_l[i] = 1.f / st.y;
    }
  }

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  float part[2] = {0.f, 0.f};  // this lane's share of rowsum(dP ⊙ P)
  float Drow[2] = {0.f, 0.f};  // set after the first sweep
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBlock;
      __syncthreads();  // the previous tile is consumed
      stage<D>(k + head, in.row, k0, seq, Ks, sweep == 1 ? Kt : nullptr);
      stage<D>(v + head, in.row, k0, seq, Vs, nullptr);
      for (int i = tid; i < kBlock; i += kMmaThreads) Ms[i] = k0 + i < seq ? mrow[k0 + i] : 0;
      __syncthreads();

      float s[kNTiles][4], dp[kNTiles][4];
      product_rows<D>(s, qa, Ks, g, c);
      product_rows<D>(dp, da, Vs, g, c);
      uint32_t dsa[kBlock / 16][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * c + (e & 1), i = e >> 1;
          const float x = Ms[col] ? -FLT_MAX : s[nt][e] * scale;
          const float p = row_in[i] && k0 + col < seq ? expf(x - m[i]) * inv_l[i] : 0.f;
          if (sweep == 0) part[i] += p * dp[nt][e];
          ds[e] = sweep == 0 ? 0.f : p * (dp[nt][e] - Drow[i]);
        }
        pack_a(dsa, nt, ds);
      }
      if (sweep == 1) product_cols<D>(acc, dsa, Kt, g, c);
    }
    if (sweep == 0) {
      Drow[0] = quad_sum(part[0]);
      Drow[1] = quad_sum(part[1]);
      if (c == 0) {
        if (row_in[0]) dsum[rows + row0] = Drow[0];
        if (row_in[1]) dsum[rows + row0 + 8] = Drow[1];
      }
    }
  }
  store_rows<D>(dq + head, in.row, acc, row0, row_in[0], row_in[1], scale, c);
}

// Pass 2: dK and dV. Each warp owns 16 keys and walks the query tiles; the
// products run transposed (keys as rows), so Sᵀ = K Qᵀ and dPᵀ = V dOᵀ.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
              const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int H, int seq, float scale, HeadStrides in,
              HeadStrides out) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 Qs[kBlock * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 Qt[D * (kBlock + kPad)];
  __shared__ __align__(16) __nv_bfloat16 Os[kBlock * (D + kPad)];  // dO rows
  __shared__ __align__(16) __nv_bfloat16 Ot[D * (kBlock + kPad)];  // dO transposed
  __shared__ float Mq[kBlock], Lq[kBlock], Dq[kBlock];  // m, 1/l, D of the query rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int key0 = blockIdx.x * kBlock + (tid >> 5) * 16 + g;  // and key0 + 8
  const size_t rows = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)seq;
  const size_t head = in.at(blockIdx.z, blockIdx.y), ohead = out.at(blockIdx.z, blockIdx.y);
  const uint8_t* mrow = mask + (size_t)blockIdx.z * seq;
  const bool kin[2] = {key0 < seq, key0 + 8 < seq};
  const bool masked[2] = {kin[0] && mrow[key0] != 0, kin[1] && mrow[key0 + 8] != 0};

  uint32_t ka[D / 16][4], va[D / 16][4];  // the warp's keys of K and V
  load_a_rows<D>(ka, k + head, in.row, key0, kin[0], kin[1], c);
  load_a_rows<D>(va, v + head, in.row, key0, kin[0], kin[1], c);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // the previous tile is consumed
    stage<D>(q + head, in.row, q0, seq, Qs, Qt);
    stage<D>(dout + ohead, out.row, q0, seq, Os, Ot);
    for (int i = tid; i < kBlock; i += kMmaThreads) {
      const bool valid = q0 + i < seq;
      const float2 st = valid ? *reinterpret_cast<const float2*>(stats + 2 * (rows + q0 + i))
                              : make_float2(0.f, 1.f);
      Mq[i] = st.x;
      Lq[i] = valid ? 1.f / st.y : 0.f;
      Dq[i] = valid ? dsum[rows + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
    product_rows<D>(s, ka, Qs, g, c);   // Sᵀ: 16 keys × 64 queries
    product_rows<D>(dp, va, Os, g, c);  // dPᵀ
    uint32_t pa[kBlock / 16][4], dsa[kBlock / 16][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * c + (e & 1), i = e >> 1;
        const float x = masked[i] ? -FLT_MAX : s[nt][e] * scale;
        p[e] = kin[i] && q0 + col < seq ? expf(x - Mq[col]) * Lq[col] : 0.f;
        ds[e] = p[e] * (dp[nt][e] - Dq[col]);
      }
      pack_a(pa, nt, p);
      pack_a(dsa, nt, ds);
    }
    product_cols<D>(dv_acc, pa, Ot, g, c);
    product_cols<D>(dk_acc, dsa, Qt, g, c);
  }
  store_rows<D>(dk + head, in.row, dk_acc, key0, kin[0], kin[1], scale, c);
  store_rows<D>(dv + head, in.row, dv_acc, key0, kin[0], kin[1], 1.f, c);
}

// ------------------------------------------------------------ f32, CUDA cores

constexpr int kThreads = 256;  // 16 row groups × 16 column lanes
constexpr int kRows = 4;       // rows ty*4 .. ty*4+3 of a 64 × 64 tile
constexpr int kCols = 4;       // columns tx + 16·j of a 64 × 64 tile
constexpr int kTS = kBlock + 1;  // stride of a 64 × 64 f32 tile in shared memory

// Copy rows r0 .. r0+63 of a row-major f32 matrix of D columns (rows ld
// apart) into shared memory with a one-float pad per row; rows past T are
// zero.
template <int D>
__device__ __forceinline__ void stage_f32(const float* src, int ld, int r0, int seq, float* dst) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, col = i % D;
    dst[r * (D + 1) + col] = r0 + r < seq ? src[(size_t)(r0 + r) * ld + col] : 0.f;
  }
}

// a (4 × 4 of a 64 × 64 tile) = rows ty·4+r of A · rows tx+16j of B, both
// (64 × D) staged with stride D + 1
template <int D>
__device__ __forceinline__ void dot_tile(float (&a)[kRows][kCols], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[r][j] = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < D; ++dd) {
    float x[kRows], y[kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r] = A[(ty * kRows + r) * (D + 1) + dd];
#pragma unroll
    for (int j = 0; j < kCols; ++j) y[j] = B[(tx + 16 * j) * (D + 1) + dd];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) a[r][j] = fmaf(x[r], y[j], a[r][j]);
  }
}

// acc (rows ty·4+r, columns tx+16j of D) += P (64 × 64, stride kTS) · B (64 × D)
template <int D>
__device__ __forceinline__ void acc_tile(float (&acc)[kRows][D / 16], const float* P,
                                         const float* B, int used, int ty, int tx) {
  for (int kk = 0; kk < used; ++kk) {
    float y[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = B[kk * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = P[(ty * kRows + r) * kTS + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[r][j] = fmaf(p, y[j], acc[r][j]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {  // Q, dO, K, V tiles and the dS tile
  return 4 * kBlock * (D + 1) + kBlock * kTS;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const uint8_t* __restrict__ mask, const float* __restrict__ dout,
           const float* __restrict__ stats, float* __restrict__ dsum, float* __restrict__ dq,
           int H, int seq, float scale, HeadStrides in, HeadStrides out) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kBlock * (D + 1);
  float* Ks = Os + kBlock * (D + 1);
  float* Vs = Ks + kBlock * (D + 1);
  float* Ss = Vs + kBlock * (D + 1);  // dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBlock;
  const size_t rows = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)seq;
  const size_t head = in.at(blockIdx.z, blockIdx.y), ohead = out.at(blockIdx.z, blockIdx.y);
  const uint8_t* mrow = mask + (size_t)blockIdx.z * seq;
  stage_f32<D>(q + head, in.row, q0, seq, Qs);
  stage_f32<D>(dout + ohead, out.row, q0, seq, Os);

  float m[kRows], inv_l[kRows], part[kRows], Drow[kRows], acc[kRows][D / 16];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    const float2 st = row < seq ? *reinterpret_cast<const float2*>(stats + 2 * (rows + row))
                                : make_float2(0.f, 0.f);
    m[r] = st.x;
    inv_l[r] = row < seq ? 1.f / st.y : 0.f;
    part[r] = Drow[r] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r][j] = 0.f;
  }

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBlock;
      __syncthreads();
      stage_f32<D>(k + head, in.row, k0, seq, Ks);
      stage_f32<D>(v + head, in.row, k0, seq, Vs);
      __syncthreads();
      float s[kRows][kCols], dp[kRows][kCols];
      dot_tile<D>(s, Qs, Ks, ty, tx);
      dot_tile<D>(dp, Os, Vs, ty, tx);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool row_in = q0 + ty * kRows + r < seq;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int key = k0 + tx + 16 * j;
          const bool valid = row_in && key < seq;
          const float x = valid && mrow[key] ? -FLT_MAX : s[r][j] * scale;
          const float p = valid ? expf(x - m[r]) * inv_l[r] : 0.f;
          if (sweep == 0)
            part[r] += p * dp[r][j];
          else
            Ss[(ty * kRows + r) * kTS + tx + 16 * j] = p * (dp[r][j] - Drow[r]);
        }
      }
      if (sweep == 1) {
        __syncthreads();
        acc_tile<D>(acc, Ss, Ks, min(kBlock, seq - k0), ty, tx);
      }
    }
    if (sweep == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        Drow[r] = half_warp_sum(part[r]);
        const int row = q0 + ty * kRows + r;
        if (tx == 0 && row < seq) dsum[rows + row] = Drow[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) dq[head + (size_t)row * in.row + tx + 16 * j] = acc[r][j] * scale;
    }
  }
}

template <int D>
constexpr int dkdv_smem_floats() {  // K, V, Q, dO tiles, the P and dS tiles, m, 1/l, D
  return 4 * kBlock * (D + 1) + 2 * kBlock * kTS + 3 * kBlock;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const uint8_t* __restrict__ mask,
             const float* __restrict__ dout, const float* __restrict__ stats,
             const float* __restrict__ dsum, float* __restrict__ dk, float* __restrict__ dv,
             int H, int seq, float scale, HeadStrides in, HeadStrides out) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * (D + 1);
  float* Qs = Vs + kBlock * (D + 1);
  float* Os = Qs + kBlock * (D + 1);
  float* Ps = Os + kBlock * (D + 1);  // Pᵀ: keys × queries
  float* Ss = Ps + kBlock * kTS;      // dSᵀ
  float* Mq = Ss + kBlock * kTS;
  float* Lq = Mq + kBlock;
  float* Dq = Lq + kBlock;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int key_base = blockIdx.x * kBlock;
  const size_t rows = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)seq;
  const size_t head = in.at(blockIdx.z, blockIdx.y), ohead = out.at(blockIdx.z, blockIdx.y);
  const uint8_t* mrow = mask + (size_t)blockIdx.z * seq;
  stage_f32<D>(k + head, in.row, key_base, seq, Ks);
  stage_f32<D>(v + head, in.row, key_base, seq, Vs);

  bool kin[kRows], masked[kRows];
  float dk_acc[kRows][D / 16], dv_acc[kRows][D / 16];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = key_base + ty * kRows + r;
    kin[r] = key < seq;
    masked[r] = kin[r] && mrow[key] != 0;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;
  }

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();
    stage_f32<D>(q + head, in.row, q0, seq, Qs);
    stage_f32<D>(dout + ohead, out.row, q0, seq, Os);
    for (int i = tid; i < kBlock; i += kThreads) {
      const bool valid = q0 + i < seq;
      const float2 st = valid ? *reinterpret_cast<const float2*>(stats + 2 * (rows + q0 + i))
                              : make_float2(0.f, 1.f);
      Mq[i] = st.x;
      Lq[i] = valid ? 1.f / st.y : 0.f;
      Dq[i] = valid ? dsum[rows + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    dot_tile<D>(s, Ks, Qs, ty, tx);  // Sᵀ
    dot_tile<D>(dp, Vs, Os, ty, tx);  // dPᵀ
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const bool valid = kin[r] && q0 + col < seq;
        const float x = masked[r] ? -FLT_MAX : s[r][j] * scale;
        const float p = valid ? expf(x - Mq[col]) * Lq[col] : 0.f;
        Ps[(ty * kRows + r) * kTS + col] = p;
        Ss[(ty * kRows + r) * kTS + col] = p * (dp[r][j] - Dq[col]);
      }
    }
    __syncthreads();
    const int used = min(kBlock, seq - q0);
    acc_tile<D>(dv_acc, Ps, Os, used, ty, tx);
    acc_tile<D>(dk_acc, Ss, Qs, used, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = key_base + ty * kRows + r;
    if (key < seq) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        dk[head + (size_t)key * in.row + tx + 16 * j] = dk_acc[r][j] * scale;
        dv[head + (size_t)key * in.row + tx + 16 * j] = dv_acc[r][j];
      }
    }
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *dout;
  const uint8_t* mask;
  const float* stats;
  float* dsum;
  void *dq, *dk, *dv;
  int B, H, seq;
  float scale;
  HeadStrides in, out;  // q, k, v, dq, dk, dv; dO
  cudaStream_t stream;
};

template <int D, int KT>
cudaError_t launch_single_pass(const Args& a) {
  CUtensorMap mq, mk, mv, mdo, mdq, mdk, mdv, mm;
  const HeadStrides& i = a.in;
  const HeadStrides& o = a.out;
  if (!make_head_map(&mq, a.q, D, a.seq, a.H, a.B, i.row, i.head, i.batch, KT) ||
      !make_head_map(&mk, a.k, D, a.seq, a.H, a.B, i.row, i.head, i.batch, KT) ||
      !make_head_map(&mv, a.v, D, a.seq, a.H, a.B, i.row, i.head, i.batch, KT) ||
      !make_head_map(&mdo, a.dout, D, a.seq, a.H, a.B, o.row, o.head, o.batch, KT) ||
      !make_head_map(&mdq, a.dq, D, a.seq, a.H, a.B, i.row, i.head, i.batch, 64) ||
      !make_head_map(&mdk, a.dk, D, a.seq, a.H, a.B, i.row, i.head, i.batch, 64) ||
      !make_head_map(&mdv, a.dv, D, a.seq, a.H, a.B, i.row, i.head, i.batch, 64) ||
      !make_byte_map(&mm, a.mask, (long long)a.B * a.seq, Smem<D, KT>::kMaskBox))
    return cudaErrorInvalidValue;
  const int items = a.B * a.H;  // below 2³¹, checked by the caller
  auto kernel = bwd_single_pass_bf16<D, KT>;
  constexpr int smem = Smem<D, KT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = items < sm_count() ? items : sm_count();
  kernel<<<grid, 128 * (1 + KT / 64), smem, a.stream>>>(mq, mk, mv, mdo, mdq, mdk, mdv, mm,
                                                         a.stats, a.H, a.seq, a.scale, items);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_two_pass(const Args& a) {
  using bf = __nv_bfloat16;
  dim3 grid((a.seq + kBlock - 1) / kBlock, a.H, a.B);
  bwd_dq_bf16<D><<<grid, kMmaThreads, 0, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      a.mask, static_cast<const bf*>(a.dout), a.stats, a.dsum, static_cast<bf*>(a.dq), a.H,
      a.seq, a.scale, a.in, a.out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_bf16<D><<<grid, kMmaThreads, 0, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      a.mask, static_cast<const bf*>(a.dout), a.stats, a.dsum, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.H, a.seq, a.scale, a.in, a.out);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  const int smem_dq = dq_smem_floats<D>() * sizeof(float);
  const int smem_dkdv = dkdv_smem_floats<D>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkdv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkdv);
  if (err != cudaSuccess) return err;
  dim3 grid((a.seq + kBlock - 1) / kBlock, a.H, a.B);
  bwd_dq_f32<D><<<grid, kThreads, smem_dq, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<const float*>(a.dout), a.stats,
      a.dsum, static_cast<float*>(a.dq), a.H, a.seq, a.scale, a.in, a.out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_f32<D><<<grid, kThreads, smem_dkdv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<const float*>(a.dout), a.stats,
      a.dsum, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.seq, a.scale, a.in,
      a.out);
  return cudaGetLastError();
}

}  // namespace flash_bwd

// Which kernel takes a backward: the one place that chooses, for the flash
// path and the fused block alike.
enum FlashBwdRoute { kBwdFma = 0, kBwdSinglePass = 1, kBwdTwoPass = 2, kBwdNone = -1 };
inline int flash_bwd_route(int seq, int head_dim, int dtype) {
  if (seq <= 0 || (head_dim != 32 && head_dim != 64)) return kBwdNone;
  if (dtype == 0) return kBwdFma;
  if (dtype != 1) return kBwdNone;
  return seq <= flash_bwd::kSinglePassMaxT ? kBwdSinglePass : kBwdTwoPass;
}

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t
// (0 = launched); cudaErrorInvalidValue for a shape or type it does not take.
// q, k, v, dq, dk, dv at `in` and dout at `out` (see HeadStrides; rows
// 16-byte aligned); mask contiguous (B, T) bytes; stats the forward's
// (B, H, T, 2) f32 row (m, l); dsum (B, H, T) f32 scratch that the two-pass
// route's first pass fills and its second reads (unused at T ≤ 128 in bf16).
inline cudaError_t flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const uint8_t* mask, const void* dout, const float* stats,
                                       float* dsum, void* dq, void* dk, void* dv, int B, int H,
                                       int seq, int head_dim, int dtype, float scale,
                                       HeadStrides in, HeadStrides out, cudaStream_t stream) {
  using namespace flash_bwd;
  if (B <= 0 || H <= 0 || seq <= 0 || B > 65535 || H > 65535 || (long long)B * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, mask, stats, dsum, dq, dk, dv, B, H, seq, scale, in, out, stream};
  const bool d64 = head_dim == 64;
  switch (flash_bwd_route(seq, head_dim, dtype)) {
    case kBwdFma:
      return d64 ? launch_f32<64>(a) : launch_f32<32>(a);
    case kBwdSinglePass:
      if (seq <= 64) return d64 ? launch_single_pass<64, 64>(a) : launch_single_pass<32, 64>(a);
      return d64 ? launch_single_pass<64, 128>(a) : launch_single_pass<32, 128>(a);
    case kBwdTwoPass:
      return d64 ? launch_two_pass<64>(a) : launch_two_pass<32>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wavjepa
