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
//   * T > 128 (WavJEPA-Nat's packed encoder and decoder, T = 176 and 256,
//     and the unpacked 200-token encoder of the denoiser): two deterministic
//     passes over 64-row items, built as the one-pass kernel is. Every sum
//     stays in one block, so D = rowsum(dP ⊙ P) is exact as the TPU kernel
//     takes it (rowsum(dO ⊙ O) would differ by the forward's bf16 rounding
//     of P and O) and no partial dQ crosses blocks:
//       1. bwd_dq_bf16: an item is (batch, head, 64 query rows). Q and dO
//          are loaded once; K, V and the keys' mask bytes stream past in
//          tiles of 64 keys, twice. The first sweep forms S = Q·Kᵀ and
//          dP = dO·Vᵀ (wgmma, both operands in shared memory) and sums D,
//          which goes to the caller's scratch `dsum`; the second forms them
//          again, dS in registers, and dQ += dS_lo·K (wgmma with dS_lo from
//          registers, K read MN-major).
//       2. bwd_dkdv_bf16: an item is (batch, head, 64 keys). K and V are
//          loaded once; Q, dO and the rows' (m, l) and D stream past in tiles
//          of 64 query rows. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then Pᵀ and dSᵀ in
//          registers, dV += Pᵀ_lo·dO and dK += dSᵀ_lo·Q (dO and Q MN-major).
//     What bounds them. Nine T×T×d products instead of five (S and dP are
//     formed three times) and three exponentials a score instead of one;
//     both stay far above the byte bound, which a T² score block in device
//     memory (the only way to five products and one exponential without
//     cross-block sums) would break at these T. Yet neither the tensor
//     cores nor the special function unit's 2^x is what holds a step: the
//     chain of one 64-row step (its products, then its scores' softmax,
//     then the products that use them) is, so the design keeps two such
//     chains on every SM and no load on them. Each block is persistent (one
//     an SM) and runs two pipelines, each one producer thread that keeps
//     TMA loads of the walked side in flight (a ring of 4 stages, full and
//     empty mbarriers; the item's own tiles in two slots, so the next item
//     loads under the current one) and one consumer warpgroup of 64 rows.
//     No value is transposed by a thread: every product is wgmma, the
//     accumulating ones with their A from registers and B read MN-major,
//     skipping their 16-row steps past T. P = 2^(s·scale·log2(e) −
//     m·log2(e)) / l as in the forward and the one-pass kernel; each step's
//     per-key (pass 1) or per-row (pass 2) terms go through a 64-entry
//     table that the warpgroup builds once. The rank-4 tensor maps read
//     both HeadStrides layouts and zero-fill rows past T; the row statistics
//     and D come in 1-D boxes from the 16-byte boundary at or before the
//     tile's first row. dq, dk, dv are rounded into the item's own tiles
//     (read for the last time) and stored by TMA, which drops rows past T.
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

constexpr int kBlock = 64;  // rows a block owns, and rows of a tile it walks (f32)

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
    pack_a<KT>(dsa, dp);
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

// ------------------------------------- bf16, T > 128: two passes, TMA and wgmma

constexpr int kPipes = 2;      // pipelines a block: a producer thread and a consumer warpgroup each
constexpr int kPassThreads = 128 * (1 + kPipes);  // the producers' warpgroup, then the consumers
constexpr int kTileRows = 64;  // rows of an item, and of a tile of the walked side
constexpr int kTileMaskBox = kTileRows + 16;  // a key tile's mask bytes from the 16-byte boundary
constexpr int kStatsBox = 2 * kTileRows + 4;  // a query tile's (m, l), f32, likewise
constexpr int kDsumBox = kTileRows + 4;       // its D

// Shared memory of a pipeline, from a 1024-aligned base: two slots of the
// item's own pair of tiles (Q and dO in pass 1, K and V in pass 2), the ring
// of the walked pair (K and V, or Q and dO), each stage's extra bytes, then
// the barriers: the slots' full and empty, the stages' full and empty. A
// stage's extra bytes hold what TMA loads beside the tiles (pass 1: the
// keys' mask bytes; pass 2: the rows' (m, l), then their D) and, at kTable,
// the consumer's table of the tile's 64 rows made from them (pass 1: each
// key's additive term; pass 2: each query row's (m·log2(e), 1/l, D)).
template <int D>
struct PassSmem {
  static constexpr int kTile = kTileRows * 2 * D;  // 64 rows of q, k, v or dO
  static constexpr int kStages = 4;
  static constexpr int kHeld = 0;
  static constexpr int kRing = kHeld + 2 * 2 * kTile;
  static constexpr int kExtra = kRing + kStages * 2 * kTile;
  static constexpr int kDsum = 640;    // D's offset in a stage's extra bytes
  static constexpr int kTable = 1024;  // the table's
  static constexpr int kExtraStride = 2048;
  static constexpr int kBars = kExtra + kStages * kExtraStride;
  static constexpr int kPipe = (kBars + (4 + 2 * kStages) * 8 + 1023) / 1024 * 1024;
  static constexpr int kBytes = kPipes * kPipe + 1024;
  static_assert(kTileMaskBox <= kTable && 4 * kStatsBox <= kDsum &&
                    kDsum + 4 * kDsumBox <= kTable && kTable + 16 * kTileRows <= kExtraStride,
                "extra bytes");
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// A pipeline's barriers: slot i's full and empty, stage s's full and empty.
template <int D>
struct PassBars {
  uint32_t bars;
  __device__ uint32_t held_full(int i) const { return bars + 8 * i; }
  __device__ uint32_t held_empty(int i) const { return bars + 16 + 8 * i; }
  __device__ uint32_t ring_full(int s) const { return bars + 32 + 8 * s; }
  __device__ uint32_t ring_empty(int s) const { return bars + 32 + 8 * (PassSmem<D>::kStages + s); }
};

__device__ __forceinline__ void advance(int& i, int& phase, int n) {
  if (++i == n) {
    i = 0;
    phase ^= 1;
  }
}

// Every pipeline's barriers: a slot or stage is full once its producer's
// expect_tx and bytes have arrived; a slot is empty once its consumer's
// stores have read it, a stage once each of the consumer's warps is done.
template <int D>
__device__ __forceinline__ void init_pass_bars(uint32_t base0) {
  using L = PassSmem<D>;
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPipes; ++p) {
      const PassBars<D> bar{base0 + p * L::kPipe + L::kBars};
      for (int i = 0; i < 2; ++i) {
        bar_init(bar.held_full(i), 1);
        bar_init(bar.held_empty(i), 1);
      }
      for (int s = 0; s < L::kStages; ++s) {
        bar_init(bar.ring_full(s), 1);
        bar_init(bar.ring_empty(s), 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The consumer's 64-row result tile a (D/2 sums a lane: rows r, r + 8 of the
// layout in hopper_common.cuh), times mul, rounded into a swizzled tile.
template <int D>
__device__ __forceinline__ void round_into(uint32_t tile, const float (&a)[D / 2], float mul, int r,
                                           int c) {
  constexpr int W = 2 * D;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    st_shared(tile + swizzled<W>(r, u) + 4 * c, pack_bf16x2(a[4 * u] * mul, a[4 * u + 1] * mul));
    st_shared(tile + swizzled<W>(r + 8, u) + 4 * c,
              pack_bf16x2(a[4 * u + 2] * mul, a[4 * u + 3] * mul));
  }
}

// The slot whose results an item stored goes back to the producer once the
// store has read it. The consumer asks after the next item's first products
// are issued, so that the wait runs under them (the producer needs the slot
// only for the item after that); `stored` is then none.
template <int D>
__device__ __forceinline__ void release_stored(int& stored, const PassBars<D>& bar) {
  if (stored >= 0 && threadIdx.x % 128 == 0) {
    bulk_wait<true>();
    bar_arrive(bar.held_empty(stored));
  }
  stored = -1;
}

// S += A·Bᵀ for the 64 rows of tile a and the 64 of tile b (both K-major,
// rows of 2·D bytes), D/16 k-steps.
template <int D>
__device__ __forceinline__ void product_ab(float (&s)[kTileRows / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma<kTileRows, 0, 0>(s, k_major<2 * D>(a, ks), k_major<2 * D>(b, ks));
}

// Pass 1: dQ, and D = rowsum(dP ⊙ P) for pass 2. Maps: q, k, v, dO, dq in
// boxes of 64 rows; the mask in boxes of kTileMaskBox bytes.
template <int D>
__global__ void __launch_bounds__(kPassThreads, 1)
bwd_dq_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
            const __grid_constant__ CUtensorMap map_dq,
            const __grid_constant__ CUtensorMap map_mask, const float* __restrict__ stats,
            float* __restrict__ dsum, int H, int seq, float scale, int blocks, int items) {
  using L = PassSmem<D>;
  constexpr int W = 2 * D, S = L::kStages, N = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint8_t* const smem0 = smem_raw + (base0 - smem_addr(smem_raw));  // generic view of base0
  const int n_tiles = (seq + N - 1) / N;
  init_pass_bars<D>(base0);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 32 != 0 || threadIdx.x / 32 >= kPipes) return;
    // lane 0 of warp p feeds pipeline p: each item's Q and dO, then its key
    // tiles twice (K, V and the mask bytes from the 16-byte boundary
    // at or before the tile's first key, which may run past T: the consumer
    // looks at the key index first)
    const int p = threadIdx.x / 32;
    const uint32_t base = base0 + p * L::kPipe;
    const PassBars<D> bar{base + L::kBars};
    int slot = 0, slot_phase = 0, st = 0, phase = 0;
    for (int t = kPipes * blockIdx.x + p; t < items; t += kPipes * gridDim.x) {
      const int qb = t % blocks, h = (t / blocks) % H, b = t / blocks / H;
      bar_wait(bar.held_empty(slot), slot_phase ^ 1);  // the first pass finds both free
      const uint32_t held = base + L::kHeld + slot * 2 * L::kTile;
      bar_expect_tx(bar.held_full(slot), 2 * L::kTile);
      tma_load_4d(held, &map_q, bar.held_full(slot), 0, qb * N, h, b);
      tma_load_4d(held + L::kTile, &map_do, bar.held_full(slot), 0, qb * N, h, b);
      advance(slot, slot_phase, 2);
      for (int sweep = 0; sweep < 2; ++sweep) {
        for (int j = 0; j < n_tiles; ++j) {
          bar_wait(bar.ring_empty(st), phase ^ 1);
          const uint32_t tiles = base + L::kRing + st * 2 * L::kTile;
          bar_expect_tx(bar.ring_full(st), 2 * L::kTile + kTileMaskBox);
          tma_load_4d(tiles, &map_k, bar.ring_full(st), 0, j * N, h, b);
          tma_load_4d(tiles + L::kTile, &map_v, bar.ring_full(st), 0, j * N, h, b);
          tma_load_1d(base + L::kExtra + st * L::kExtraStride, &map_mask, bar.ring_full(st),
                      (b * seq + j * N) & ~15);
          advance(st, phase, S);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int p = threadIdx.x / 128 - 1;
  const uint32_t base = base0 + p * L::kPipe;
  const uint8_t* const extra = smem0 + p * L::kPipe + L::kExtra;
  const PassBars<D> bar{base + L::kBars};
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  const int r = 16 * warp + g;  // this lane's rows r and r + 8 of the item's 64
  const float scale2 = scale * kLog2e;
  const int first = kPipes * blockIdx.x + p, stride = kPipes * gridDim.x;
  const int steps = 2 * n_tiles;  // the key tiles, once for D and once for dS
  // the (m, l) of rows r and r + 8 of item t, loaded one item ahead
  const float2* const stats2 = reinterpret_cast<const float2*>(stats);
  float2 st_next[2];
  auto load_stats = [&](int t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = (t % blocks) * N + r + 8 * e;
      st_next[e] = t < items && row < seq ? stats2[(size_t)(t / blocks) * seq + row]
                                          : make_float2(0.f, 1.f);
    }
  };
  load_stats(first);
  int slot = 0, slot_phase = 0, st = 0, phase = 0;
  int stored = -1;  // the slot whose result tile a TMA store may still be reading
  for (int t = first; t < items; t += stride) {
    const int qb = t % blocks, bh = t / blocks, h = bh % H, b = bh / H;
    const int q0 = qb * N;
    // in the log2 domain, as the forward: a fully masked row's max is the
    // sentinel itself, so that its masked keys get 2^0; a row past T gets
    // m = +inf and 1/l = 0, so that its P is 0
    float m2[2], inv_l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = q0 + r + 8 * e < seq;
      m2[e] = !in ? INFINITY : st_next[e].x == -FLT_MAX ? -FLT_MAX : st_next[e].x * kLog2e;
      inv_l[e] = in ? 1.f / st_next[e].y : 0.f;
    }
    load_stats(t + stride);
    const uint32_t q_t = base + L::kHeld + slot * 2 * L::kTile, do_t = q_t + L::kTile;
    bar_wait(bar.held_full(slot), slot_phase);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    uint32_t dsa[N / 16][4];  // dS_lo of a tile, the A operand of dS·K
    float s[N / 2], dp[N / 2];
    float part[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};  // this lane's share of D, then D
    // S = Q Kᵀ and dP = dO Vᵀ of the item's rows and the keys at stage st
    auto issue_s = [&] {
      const uint32_t k_t = base + L::kRing + st * 2 * L::kTile;
      for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
      keep(s);
      keep(dp);
      wgmma_fence();
      product_ab<D>(s, q_t, k_t);
      product_ab<D>(dp, do_t, k_t + L::kTile);
      wgmma_commit();
    };
    bar_wait(bar.ring_full(st), phase);
    issue_s();
    release_stored(stored, bar);
    // Step n: the key tile of sweep n / n_tiles at stage st, its S and dP
    // in flight, and after them the dS·K product of step n − 1 in sweep 1.
    // Waits for both (the tile's stage before is then free), makes the
    // tile's P and D's share (sweep 0) or dS and dQ += dS_lo·K (sweep 1),
    // then issues the next step's S and dP. Nothing stays in flight across
    // a step's start: issuing the next S and dP before this tile's P (two
    // tiles' scores in registers, which the 168 registers a thread of a
    // 384-thread block gets do not hold without spilling) measured slower
    // at d = 32 and no faster at d = 64. The block's two pipelines overlap
    // each other's products and exponentials instead.
    for (int n = 0; n < steps; ++n) {
      const int sweep = n >= n_tiles, k0 = (n - sweep * n_tiles) * N, cur = st;
      wgmma_wait<0>();
      keep(s);
      keep(dp);
      keep(dq);
      keep(dsa);
      if (sweep == 1 && k0 > 0 && lane == 0)  // the dS·K product of the tile before
        bar_arrive(bar.ring_empty(cur == 0 ? S - 1 : cur - 1));
      // the tile's keys' additive terms (key_bias), one a thread
      const uint8_t* const ex = extra + cur * L::kExtraStride;
      float* const table = reinterpret_cast<float*>(const_cast<uint8_t*>(ex) + L::kTable);
      if (tid < N) table[tid] = key_bias(k0 + tid, seq, ex[((b * seq + k0) & 15) + tid]);
      named_sync(1 + p, 128);
      // P = 2^(s·scale2 + bias − m2)/l: key 8·(i/4) + 2c + (i & 1) of the
      // tile holds s[i] of rows r ((i >> 1) & 1 = 0) and r + 8
#pragma unroll
      for (int i = 0; i < N / 2; i += 4) {
        const float2 bias = *reinterpret_cast<const float2*>(table + 8 * (i / 4) + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1;
          const float x = fmaf(s[i + e], scale2, e & 1 ? bias.y : bias.x);
          const float pv = exp2_fast(x - m2[row]) * inv_l[row];
          if (sweep == 0)
            part[row] += pv * dp[i + e];
          else
            dp[i + e] = pv * (dp[i + e] - drow[row]);
        }
      }
      if (sweep == 0) {
        __syncwarp();  // the warp is done with the stage's mask bytes and table
        if (lane == 0) bar_arrive(bar.ring_empty(cur));
        if (k0 + N >= seq) {  // the last tile: D of rows r, r + 8
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            drow[e] = quad_sum(part[e]);
            if (c == 0 && q0 + r + 8 * e < seq) dsum[(size_t)bh * seq + q0 + r + 8 * e] = drow[e];
          }
        }
      } else {
        // dQ += dS_lo K (K MN-major) over the 16-key steps that hold a key < T
        pack_a<N>(dsa, dp);
        keep(dq);
        wgmma_fence();
        const uint32_t k_t = base + L::kRing + cur * 2 * L::kTile;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          if (k0 + 16 * kk < seq) wgmma_rs<D, 1>(dq, dsa[kk], mn_major<W>(k_t, kk));
        wgmma_commit();
      }
      advance(st, phase, S);
      if (n + 1 < steps) {
        bar_wait(bar.ring_full(st), phase);
        issue_s();
      }
    }
    wgmma_wait<0>();
    keep(dq);
    keep(dsa);
    if (lane == 0) bar_arrive(bar.ring_empty(st == 0 ? S - 1 : st - 1));

    // dq rounded into the slot's Q tile, read for the last time, and stored
    // by TMA; the slot goes back to the producer once the store has read it
    round_into<D>(q_t, dq, scale, r, c);
    fence_async_shared();
    named_sync(1 + p, 128);
    if (tid == 0) {
      tma_store_4d(&map_dq, q_t, 0, q0, h, b);
      bulk_commit();
    }
    stored = slot;
    advance(slot, slot_phase, 2);
  }
  release_stored(stored, bar);
  if (tid == 0) bulk_wait<false>();
}

// Pass 2: dK and dV, with pass 1's D. The products run transposed (keys as
// rows): Sᵀ = K Qᵀ, dPᵀ = V dOᵀ. Maps: q, k, v, dO, dk, dv in boxes of 64
// rows; the row statistics (B·H·T·2 floats) and D (B·H·T) in boxes of
// kStatsBox and kDsumBox floats.
template <int D>
__global__ void __launch_bounds__(kPassThreads, 1)
bwd_dkdv_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_dk,
              const __grid_constant__ CUtensorMap map_dv,
              const __grid_constant__ CUtensorMap map_stats,
              const __grid_constant__ CUtensorMap map_dsum, const uint8_t* __restrict__ mask,
              int H, int seq, float scale, int blocks, int items) {
  using L = PassSmem<D>;
  constexpr int W = 2 * D, S = L::kStages, N = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint8_t* const smem0 = smem_raw + (base0 - smem_addr(smem_raw));
  const int n_tiles = (seq + N - 1) / N;
  init_pass_bars<D>(base0);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 32 != 0 || threadIdx.x / 32 >= kPipes) return;
    // lane 0 of warp p feeds pipeline p: each item's K and V, then its
    // query tiles (Q, dO, and the rows' (m, l) and D from the 16-byte
    // boundary at or before the tile's first row)
    const int p = threadIdx.x / 32;
    const uint32_t base = base0 + p * L::kPipe;
    const PassBars<D> bar{base + L::kBars};
    int slot = 0, slot_phase = 0, st = 0, phase = 0;
    for (int t = kPipes * blockIdx.x + p; t < items; t += kPipes * gridDim.x) {
      const int kb = t % blocks, h = (t / blocks) % H, b = t / blocks / H;
      bar_wait(bar.held_empty(slot), slot_phase ^ 1);
      const uint32_t held = base + L::kHeld + slot * 2 * L::kTile;
      bar_expect_tx(bar.held_full(slot), 2 * L::kTile);
      tma_load_4d(held, &map_k, bar.held_full(slot), 0, kb * N, h, b);
      tma_load_4d(held + L::kTile, &map_v, bar.held_full(slot), 0, kb * N, h, b);
      advance(slot, slot_phase, 2);
      const long long rows = (long long)(t / blocks) * seq;  // row 0 of (b, h)
      for (int j = 0; j < n_tiles; ++j) {
        bar_wait(bar.ring_empty(st), phase ^ 1);
        const uint32_t tiles = base + L::kRing + st * 2 * L::kTile;
        const uint32_t ex = base + L::kExtra + st * L::kExtraStride;
        const long long row0 = rows + j * N;
        bar_expect_tx(bar.ring_full(st), 2 * L::kTile + 4 * (kStatsBox + kDsumBox));
        tma_load_4d(tiles, &map_q, bar.ring_full(st), 0, j * N, h, b);
        tma_load_4d(tiles + L::kTile, &map_do, bar.ring_full(st), 0, j * N, h, b);
        tma_load_1d(ex, &map_stats, bar.ring_full(st), (int)((2 * row0) & ~3ll));
        tma_load_1d(ex + L::kDsum, &map_dsum, bar.ring_full(st), (int)(row0 & ~3ll));
        advance(st, phase, S);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int p = threadIdx.x / 128 - 1;
  const uint32_t base = base0 + p * L::kPipe;
  const uint8_t* const extra = smem0 + p * L::kPipe + L::kExtra;
  const PassBars<D> bar{base + L::kBars};
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  const int r = 16 * warp + g;  // this lane's keys r and r + 8 of the item's 64
  const float scale2 = scale * kLog2e;
  int slot = 0, slot_phase = 0, st = 0, phase = 0;
  int stored = -1;  // the slot whose result tiles a TMA store may still be reading
  for (int t = kPipes * blockIdx.x + p; t < items; t += kPipes * gridDim.x) {
    const int kb = t % blocks, bh = t / blocks, h = bh % H, b = bh / H;
    const int k0 = kb * N;
    const long long rows = (long long)bh * seq;
    // the additive term of keys k0 + r and k0 + r + 8 (key_bias)
    float bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + r + 8 * e;
      bias[e] = key_bias(key, seq, key < seq ? mask[(size_t)b * seq + key] : 0);
    }
    const uint32_t k_t = base + L::kHeld + slot * 2 * L::kTile, v_t = k_t + L::kTile;
    bar_wait(bar.held_full(slot), slot_phase);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    uint32_t pa[N / 16][4], dsa[N / 16][4];  // Pᵀ_lo and dSᵀ_lo, the A operands
    float s[N / 2], dp[N / 2];
    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ of the item's keys and the rows at stage st
    auto issue_s = [&] {
      const uint32_t q_t = base + L::kRing + st * 2 * L::kTile;
      for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
      keep(s);
      keep(dp);
      wgmma_fence();
      product_ab<D>(s, k_t, q_t);
      product_ab<D>(dp, v_t, q_t + L::kTile);
      wgmma_commit();
    };
    bar_wait(bar.ring_full(st), phase);
    issue_s();
    release_stored(stored, bar);
    // Step j: the query tile j at stage st, its Sᵀ and dPᵀ in flight, and
    // after them the products of step j − 1. Waits for both (the stage
    // before is then free), makes the tile's Pᵀ and dSᵀ, issues dV +=
    // Pᵀ_lo·dO and dK += dSᵀ_lo·Q, then the next step's Sᵀ and dPᵀ, as pass
    // 1 orders its steps.
    for (int j = 0; j < n_tiles; ++j) {
      const int q0 = j * N, cur = st;
      wgmma_wait<0>();
      keep(s);
      keep(dp);
      keep(dk);
      keep(dv);
      keep(pa);
      keep(dsa);
      if (j > 0 && lane == 0) bar_arrive(bar.ring_empty(cur == 0 ? S - 1 : cur - 1));
      // the tile's rows' (m·log2(e), 1/l, D), one a thread; a row past T
      // (whose slots may hold another head's) gets m = +inf, 1/l = 0, D = 0
      // so that its P and dS are 0
      const uint8_t* const ex = extra + cur * L::kExtraStride;
      float4* const table = reinterpret_cast<float4*>(const_cast<uint8_t*>(ex) + L::kTable);
      if (tid < N) {
        const float* sts = reinterpret_cast<const float*>(ex) + ((2 * (rows + q0)) & 3);
        const float* dss = reinterpret_cast<const float*>(ex + L::kDsum) + ((rows + q0) & 3);
        const bool valid = q0 + tid < seq;
        const float m = sts[2 * tid];
        table[tid] = make_float4(!valid ? INFINITY : m == -FLT_MAX ? -FLT_MAX : m * kLog2e,
                                 valid ? 1.f / sts[2 * tid + 1] : 0.f, valid ? dss[tid] : 0.f,
                                 0.f);
      }
      named_sync(1 + p, 128);
      // query 8·(i/4) + 2c + (i & 1) of the tile holds s[i] of keys r and
      // r + 8 ((i >> 1) & 1)
#pragma unroll
      for (int i = 0; i < N / 2; i += 4) {
        const float4 row[2] = {table[8 * (i / 4) + 2 * c], table[8 * (i / 4) + 2 * c + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4& q = row[e & 1];
          const float pv = exp2_fast(fmaf(s[i + e], scale2, bias[e >> 1]) - q.x) * q.y;
          s[i + e] = pv;
          dp[i + e] = pv * (dp[i + e] - q.z);
        }
      }
      // dV += Pᵀ_lo dO and dK += dSᵀ_lo Q (dO and Q MN-major) over the
      // 16-row steps that hold a query row < T
      pack_a<N>(pa, s);
      pack_a<N>(dsa, dp);
      keep(dk);
      keep(dv);
      wgmma_fence();
      const uint32_t q_t = base + L::kRing + cur * 2 * L::kTile, do_t = q_t + L::kTile;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        if (q0 + 16 * kk < seq) wgmma_rs<D, 1>(dv, pa[kk], mn_major<W>(do_t, kk));
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        if (q0 + 16 * kk < seq) wgmma_rs<D, 1>(dk, dsa[kk], mn_major<W>(q_t, kk));
      wgmma_commit();
      advance(st, phase, S);
      if (j + 1 < n_tiles) {
        bar_wait(bar.ring_full(st), phase);
        issue_s();
      }
    }
    wgmma_wait<0>();
    keep(dk);
    keep(dv);
    keep(pa);
    keep(dsa);
    if (lane == 0) bar_arrive(bar.ring_empty(st == 0 ? S - 1 : st - 1));

    // dk, dv rounded into the slot's K and V tiles, read for the last time,
    // and stored by TMA
    round_into<D>(k_t, dk, scale, r, c);
    round_into<D>(v_t, dv, 1.f, r, c);
    fence_async_shared();
    named_sync(1 + p, 128);
    if (tid == 0) {
      tma_store_4d(&map_dk, k_t, 0, k0, h, b);
      tma_store_4d(&map_dv, v_t, 0, k0, h, b);
      bulk_commit();
    }
    stored = slot;
    advance(slot, slot_phase, 2);
  }
  release_stored(stored, bar);
  if (tid == 0) bulk_wait<false>();
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

// Both passes on the caller's stream, pass 2 reading pass 1's D from dsum.
// Items of 64 rows, two a block at a time on min(⌈items/2⌉, SMs) blocks.
template <int D>
cudaError_t launch_two_pass(const Args& a) {
  CUtensorMap mq, mk, mv, mdo, mdq, mdk, mdv, mm, mst, mds;
  const HeadStrides& i = a.in;
  const HeadStrides& o = a.out;
  const long long rows = (long long)a.B * a.H * a.seq;
  if (!make_head_map(&mq, a.q, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileRows) ||
      !make_head_map(&mk, a.k, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileRows) ||
      !make_head_map(&mv, a.v, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileRows) ||
      !make_head_map(&mdo, a.dout, D, a.seq, a.H, a.B, o.row, o.head, o.batch, kTileRows) ||
      !make_head_map(&mdq, a.dq, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileRows) ||
      !make_head_map(&mdk, a.dk, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileRows) ||
      !make_head_map(&mdv, a.dv, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileRows) ||
      !make_byte_map(&mm, a.mask, (long long)a.B * a.seq, kTileMaskBox) ||
      !make_f32_map(&mst, a.stats, 2 * rows, kStatsBox) ||
      !make_f32_map(&mds, a.dsum, rows, kDsumBox))
    return cudaErrorInvalidValue;
  const int blocks = (a.seq + kTileRows - 1) / kTileRows;
  const long long items = (long long)a.B * a.H * blocks;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int smem = PassSmem<D>::kBytes;
  auto dq_kernel = bwd_dq_bf16<D>;
  auto dkdv_kernel = bwd_dkdv_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long pipes = (items + kPipes - 1) / kPipes;
  const int grid = pipes < sm_count() ? (int)pipes : sm_count();
  dq_kernel<<<grid, kPassThreads, smem, a.stream>>>(mq, mk, mv, mdo, mdq, mm, a.stats, a.dsum,
                                                          a.H, a.seq, a.scale, blocks, (int)items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kPassThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, mdk, mdv, mst, mds, a.mask, a.H, a.seq, a.scale, blocks, (int)items);
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
// path and the fused block alike. f32 on CUDA cores at any T; bf16 in one
// block per (batch, head) while a head's S and dP fit a block (T ≤ 128),
// else in the two TMA + wgmma passes over 64-row items, at any T.
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
// (B, H, T, 2) f32 row (m, l), 16-byte aligned; dsum (B, H, T) f32 scratch,
// 16-byte aligned, that the two-pass routes' first pass fills with D and
// their second reads (unused at T ≤ 128 in bf16).
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
