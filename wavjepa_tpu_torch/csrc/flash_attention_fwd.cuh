// Masked self-attention forward for Hopper (sm_90a), one pass over keys
// with an online softmax.
//
// Replaces the TPU kernel wavjepa_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd through pl.pallas_call). It computes, per (batch, head):
//     o = softmax(d^-1/2 * q k^T, masked keys set to the f32 minimum) v
// with q, k, v, o of shape (B, H, T, d) in bf16 or f32, each addressed
// through HeadStrides (attention_common.cuh): contiguous for the flash path,
// token-major column blocks for the fused block, with no copy between; and
// mask (B, T) bool, true = ignore that key. Scores and softmax are f32, the
// scale multiplies the f32 scores, P is rounded to the input type before
// P·V, and P·V accumulates in f32; the output is in the input type.
//
// What bounds it on an H100. The work is 4·B·H·T²·d operations over
// 8·B·H·T·d bytes in bf16 (q, k, v read once, o written once), an intensity
// of about T/2 operations a byte. The card needs about 295 in bf16 before its
// tensor cores, not its memory, are the limit: at the windowed T=200 and the
// training shapes (T = 88, 128) the kernel is bound by bytes (44-100 a
// byte), at the whole-clip T=999 by operations (~500 a byte).
//
// What the design does about that. The TPU kernel keeps the whole (H, T, T)
// f32 score block in VMEM; at T=999 that is 48 MB for 12 heads, and Hopper
// gives a block 227 KB. Here (bf16) the unit of work is 128 query rows of
// one (batch, head), and the keys stream past them in tiles of 128, so that
// nothing of size T² reaches device memory and the loads stay in flight
// under the products (hopper_common.cuh's primitives):
//   * persistent blocks, one an SM, walk the work items (query block
//     fastest, so that the items of one (batch, head) run side by side and
//     the second reads its K and V from L2);
//   * one producer thread keeps TMA loads in flight: each item's 128 query
//     rows into one of two Q slots, and the key tiles (K, V and the tile's
//     mask bytes) into a ring of 4 (d = 64) or 8 (d = 32) stages, each
//     tracked by a full and an empty mbarrier; it runs ahead into the next
//     items while the consumers work. One rank-4 tensor map per operand,
//     (d, T, H, B) with the HeadStrides strides in bytes, describes both
//     layouts; TMA zero-fills rows past T (a ragged tile needs no masking
//     code beyond the scores') and swizzles rows of 128 bytes (d = 64) or
//     64 bytes (d = 32). The mask is a flat byte array, loaded from the
//     16-byte boundary at or before the tile's first key;
//   * two consumer warpgroups own 64 query rows each. Per key tile: S = Q·Kᵀ
//     as wgmma m64n128k16 with both operands in shared memory, issued one
//     tile ahead so that it runs under the softmax of the tile before; the
//     online softmax in registers, in the log2 domain (one FMA takes the
//     score to s·scale·log2(e) plus its sentinel, then 2^x on the special
//     function unit); then O += P·V as wgmma with P from registers (the
//     sums' layout is the A operand's, rounded to bf16) and V read MN-major
//     through the transpose bit; the P·V steps whose 16 keys all lie past
//     T are skipped. setmaxnreg moves registers from the producer's
//     warpgroup to theirs;
//   * O, divided by the row sums, is rounded into a swizzled tile of shared
//     memory that a TMA store writes out (dropping rows past T) while the
//     warpgroup goes on to its next item.
// At T = 200 the second 128-row item holds 72 real rows and the second key
// tile 72 real keys: the products do up to 1.64× the work, which the byte
// bound leaves room for; rows and keys past T cost no device-memory bytes.
// The f32 kernel (parity checks) runs 256 threads of CUDA-core FMAs, 4×4
// scores each, on 64 × 64 tiles.
//
// Two sentinels, on purpose. A masked key gets the finite f32 minimum, as
// the JAX kernel does: a row whose keys are all masked then gets uniform
// weights over the T real keys, never NaN. A slot past T in the last key
// tile is not a key at all: it gets −inf, stays out of the max and gets
// weight 0, so it cannot join the uniform average of a fully masked row.
//
// The gated relative-position bias (relbias_flash below; WavLM's
// attention, models/wavlm.py). The same kernel, compiled with Bias, adds to
// every score of a real, unmasked key the term g[b, h, q]·E[h, k − q]:
//     o = softmax(d^-1/2 * q k^T + g ⊙ E[k − q], masked keys at the minimum) v
// where E is a per-offset f32 table (H, 256·nb), nb = ⌈T/128⌉, entry
// k − q + 128·nb − 1 of row h (the bucketed embedding of every offset a
// 128 × 128 tile pair can see, with 127 slots of margin on each side, so
// that every tile's window lies inside the row and starts 512 bytes from
// the next), built once a request, and g a (B, H, T) f32 gate a layer.
// Materialised, the bias is (B, H, T, T): at B = 16, T = 1,749 it is 1.57 GB
// in bf16 a layer, ~0.93 ms of bytes at 3.35 TB/s against the attention's
// ~0.20-ms compute bound. Here nothing of size T² exists: each key stage
// also brings the 256 table entries its tile pair needs (1 KB by TMA, on
// the stage's mbarrier), a row's gate is read once an item, and each score
// takes one shared-memory read and one multiply before its FMA. Masked keys
// keep the minimum and slots past T −inf, so the fully-masked-row rule is
// unchanged. bf16 and f32 both; forward only (serving). The kernels live
// in namespace relbias_flash, not flash_fwd, so that a trace tells them
// from the unbiased ones by name.
//
// Row statistics for the backward. When `stats` is not null the kernel also
// writes, per query row, the final running max m and sum l of exp(s − m) as
// an f32 pair (B, H, T, 2), m in the natural domain (a fully masked row's is
// the sentinel itself); flash_attention_bwd.cuh rebuilds P = exp(s − m)/l
// from them. Not a single logsumexp: for a fully masked row m is −FLT_MAX
// and m + log(l) rounds back to −FLT_MAX, which would give that row weights
// of 1 instead of 1/T. The serving path passes null and writes nothing.

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
namespace flash_fwd {

using namespace hopper;

// ------------------------------------------------------ bf16, TMA and wgmma

constexpr int kItemRows = 128;  // query rows of a work item: two warpgroups of 64
constexpr int kTileKeys = 128;  // keys a stage holds
constexpr int kWgThreads = 384; // warpgroup 0 loads, warpgroups 1 and 2 multiply
// A tile's mask bytes start anywhere, and TMA loads from 16-byte aligned
// addresses: the box starts up to 15 bytes early and is 16 bytes longer.
constexpr int kMaskBox = kTileKeys + 16;

// Shared memory of a block, from a 1024-aligned base: two Q slots, the ring
// of K/V stages, the output tiles of both warpgroups, each stage's mask
// bytes, then the barriers (Q full and empty, stage full and empty).
constexpr int kTabWindow = 256;  // table entries a (query item, key tile) pair can read

template <int D, bool Bias = false>
struct Smem {
  static constexpr int kRowBytes = 2 * D;  // one swizzled row: 128 or 64 bytes
  static constexpr int kStages = D == 64 ? 4 : 8;
  static constexpr int kQBytes = kItemRows * kRowBytes;
  static constexpr int kKBytes = kTileKeys * kRowBytes;  // K or V of a stage
  static constexpr int kKV = 2 * kQBytes;
  static constexpr int kO = kKV + kStages * 2 * kKBytes;
  static constexpr int kMask = kO + kItemRows * kRowBytes;
  static constexpr int kMaskStride = 256;  // a stage's mask bytes (TMA writes 128-aligned)
  static constexpr int kTab = kMask + kStages * kMaskStride;  // a stage's table window (Bias)
  static constexpr int kTabBytes = Bias ? kTabWindow * 4 : 0;
  static constexpr int kBars = kTab + kStages * kTabBytes;
  static constexpr int kBytes = kBars + (4 + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// s·scale·log2(e) with the sentinels (key_bias: −FLT_MAX for a masked key,
// which stays itself, −inf past T) for the N keys of a tile (this lane's
// columns 8·(i/4) + 2c + (i & 1) of rows r, (i >> 1) & 1 = 0, and r + 8), and
// their max per row in two halves; Full: every key of the tile is < T.
template <bool Full, int N>
__device__ __forceinline__ void scale_and_mask(float (&s)[N / 2], float (&tmax)[2][2],
                                               const uint8_t* ms, int keys, int c, float scale2) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 4) {
    const int col = 8 * (i / 4) + 2 * c;
    float bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias[e] = Full ? (ms[col + e] ? -FLT_MAX : 0.f) : key_bias(col + e, keys, ms[col + e]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[i + e] = fmaf(s[i + e], scale2, bias[e & 1]);
      tmax[e >> 1][(i >> 2) & 1] = fmaxf(tmax[e >> 1][(i >> 2) & 1], s[i + e]);
    }
  }
}

// scale_and_mask with the gated bias: a real, unmasked key's term is
// g2[row]·win[col − row + 127] (g2 = the row's gate times log2(e); `win` the
// stage's table window, `rlo` = 127 − the lane's row r within the item).
template <bool Full, int N>
__device__ __forceinline__ void scale_mask_bias(float (&s)[N / 2], float (&tmax)[2][2],
                                                const uint8_t* ms, int keys, int c, float scale2,
                                                const float* win, int rlo, const float (&g2)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 4) {
    const int col = 8 * (i / 4) + 2 * c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = col + (e & 1), row = e >> 1;  // rows r, r + 8
      const float add = !Full && key >= keys ? -INFINITY
                        : ms[key]            ? -FLT_MAX
                                             : g2[row] * win[key + rlo - 8 * row];
      s[i + e] = fmaf(s[i + e], scale2, add);
      tmax[row][(i >> 2) & 1] = fmaxf(tmax[row][(i >> 2) & 1], s[i + e]);
    }
  }
}

// The bf16 kernel's body; Bias adds the gated relative-position term (see
// the top of this file). The two __global__ kernels below are its
// instantiations, in namespaces of their own.
template <int D, bool Bias>
__device__ __forceinline__ void fwd_bf16(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                         const CUtensorMap& map_v, const CUtensorMap& map_o,
                                         const CUtensorMap& map_mask, const CUtensorMap& map_tab,
                                         float* __restrict__ stats, const float* __restrict__ gate,
                                         int H, int seq, float scale, int q_blocks, int items) {
  using L = Smem<D, Bias>;
  constexpr int S = L::kStages;
  constexpr int W = 2 * D;  // bytes of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint8_t* const mask_smem = smem_raw + (base - smem_addr(smem_raw)) + L::kMask;
  const float* const tab_smem =
      reinterpret_cast<const float*>(smem_raw + (base - smem_addr(smem_raw)) + L::kTab);
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 16;
  const uint32_t kv_full = q_empty + 16, kv_empty = kv_full + 8 * S;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int n_tiles = (seq + kTileKeys - 1) / kTileKeys;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(q_full + 8 * i, 1);   // the producer's expect_tx, then the bytes
      bar_init(q_empty + 8 * i, 8);  // one arrival from each consumer warp
    }
    for (int s = 0; s < S; ++s) {
      bar_init(kv_full + 8 * s, 1);
      bar_init(kv_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    // one thread: each item's 128 query rows, then its key tiles (K, V and
    // kMaskBox mask bytes from the 16-byte boundary at or before the tile's
    // first, which may run past the batch row's T: the consumers look at
    // the key index first)
    int stage = 0, phase = 0, slot = 0, slot_phase = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int qb = t % q_blocks, h = (t / q_blocks) % H, b = t / q_blocks / H;
      bar_wait(q_empty + 8 * slot, slot_phase ^ 1);  // the first pass finds both free
      bar_expect_tx(q_full + 8 * slot, L::kQBytes);
      tma_load_4d(base + slot * L::kQBytes, &map_q, q_full + 8 * slot, 0, qb * kItemRows, h, b);
      if (++slot == 2) {
        slot = 0;
        slot_phase ^= 1;
      }
      for (int j = 0; j < n_tiles; ++j) {
        bar_wait(kv_empty + 8 * stage, phase ^ 1);
        const uint32_t bar = kv_full + 8 * stage;
        const uint32_t kt = base + L::kKV + stage * 2 * L::kKBytes;
        bar_expect_tx(bar, 2 * L::kKBytes + kMaskBox + L::kTabBytes);
        tma_load_4d(kt, &map_k, bar, 0, j * kTileKeys, h, b);
        tma_load_4d(kt + L::kKBytes, &map_v, bar, 0, j * kTileKeys, h, b);
        tma_load_1d(base + L::kMask + stage * L::kMaskStride, &map_mask, bar,
                    (b * seq + j * kTileKeys) & ~15);
        if (Bias)  // offsets 128·(j − qb) − 127 .. + 127 of row h
          tma_load_1d(base + L::kTab + stage * L::kTabBytes, &map_tab, bar,
                      (2 * h * n_tiles + j - qb + n_tiles - 1) * kTileKeys);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int half = wg - 1;  // rows 64·half .. of the item
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, c = lane % 4;
  const int r = 16 * warp + g;  // this lane's rows r and r + 8 of the warpgroup's 64
  const uint32_t own = base + L::kO + half * 64 * W;  // its output tile
  const float scale2 = scale * kLog2e;  // scores to the log2 domain: 2^(s·scale2) = e^(s·scale)
  int stage = 0, phase = 0, slot = 0, slot_phase = 0;
  float sa[kTileKeys / 2], sb[kTileKeys / 2];  // S of two tiles: one in flight
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int qb = t % q_blocks, h = (t / q_blocks) % H, b = t / q_blocks / H;
    const int row0 = qb * kItemRows + 64 * half;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows r, r + 8, log2 domain
    float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // this lane's share of their sums, in two
    uint32_t pa[kTileKeys / 16][4];       // P rounded to bf16, the A operand of P·V
    bar_wait(q_full + 8 * slot, slot_phase);
    const uint32_t qa = base + slot * L::kQBytes + half * 64 * W;
    float g2[2] = {0.f, 0.f};  // the gate of rows r, r + 8, times log2(e)
    if (Bias) {
      const float* grow = gate + ((size_t)b * H + h) * (size_t)seq;
      if (row0 + r < seq) g2[0] = grow[row0 + r] * kLog2e;
      if (row0 + r + 8 < seq) g2[1] = grow[row0 + r + 8] * kLog2e;
    }

    auto issue_s = [&](float (&s)[kTileKeys / 2], int st) {
      const uint32_t kt = base + L::kKV + st * 2 * L::kKBytes;
#pragma unroll
      for (int i = 0; i < kTileKeys / 2; ++i) s[i] = 0.f;
      keep(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma<kTileKeys, 0, 0>(s, k_major<W>(qa, ks), k_major<W>(kt, ks));
      wgmma_commit();
    };
    // Tile j, its S in `s` (issued one tile earlier), at stage `st`: issue S
    // of tile j + 1 into `next`, then the softmax of tile j under it, then
    // P·V of tile j. Groups in flight on entry: S_j, P·V_{j-1}.
    auto tile = [&](float (&s)[kTileKeys / 2], float (&next)[kTileKeys / 2], int j, int st) {
      const int k0 = j * kTileKeys;
      const bool more = j + 1 < n_tiles;
      if (j == 0) wgmma_wait<0>(); else wgmma_wait<1>();  // S_j is done
      keep(s);
      if (j == n_tiles - 1 && lane == 0) bar_arrive(q_empty + 8 * slot);  // Q is read
      const int nst = st + 1 == S ? 0 : st + 1;
      if (more) {
        bar_wait(kv_full + 8 * nst, phase ^ (nst == 0));
        issue_s(next, nst);
      }
      // scale and sentinels in the log2 domain, then the online softmax of
      // rows r and r + 8 with 2^x
      const uint8_t* ms = mask_smem + st * L::kMaskStride + ((b * seq + k0) & 15);
      float tmax[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
      if (Bias) {
        const float* win = tab_smem + st * (L::kTabBytes / 4);
        const int rlo = 127 - 64 * half - r;
        if (k0 + kTileKeys <= seq)
          scale_mask_bias<true, kTileKeys>(s, tmax, ms, kTileKeys, c, scale2, win, rlo, g2);
        else
          scale_mask_bias<false, kTileKeys>(s, tmax, ms, seq - k0, c, scale2, win, rlo, g2);
      } else if (k0 + kTileKeys <= seq) {
        scale_and_mask<true, kTileKeys>(s, tmax, ms, kTileKeys, c, scale2);
      } else {
        scale_and_mask<false, kTileKeys>(s, tmax, ms, seq - k0, c, scale2);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // every tile holds at least one key < T, so m_new is finite
        const float m_new = fmaxf(m[i], quad_max(fmaxf(tmax[i][0], tmax[i][1])));
        alpha[i] = exp2_fast(m[i] - m_new);  // 2^-inf = 0 on the first tile
        m[i] = m_new;
        l[i][0] *= alpha[i];
        l[i][1] *= alpha[i];
      }
#pragma unroll
      for (int i = 0; i < kTileKeys / 2; ++i) {
        const int row = (i >> 1) & 1;
        const float p = exp2_fast(s[i] - m[row]);  // 0 past T: 2^-inf
        l[row][(i >> 2) & 1] += p;
        s[i] = p;
      }
      // P·V of tile j - 1 must be done before its A registers and the sums
      // change; its stage is then free
      if (more) wgmma_wait<1>(); else wgmma_wait<0>();
      keep(o);
      keep(pa);
      if (j > 0 && lane == 0) bar_arrive(kv_empty + 8 * (st == 0 ? S - 1 : st - 1));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_a<kTileKeys>(pa, s);
      // O += P V over the 16-key steps that hold a key < T
      const uint32_t vt = base + L::kKV + st * 2 * L::kKBytes + L::kKBytes;
      keep(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk)
        if (k0 + 16 * kk < seq) wgmma_rs<D, 1>(o, pa[kk], mn_major<W>(vt, kk));
      wgmma_commit();
    };

    bar_wait(kv_full + 8 * stage, phase);
    issue_s(sa, stage);
    for (int j = 0; j < n_tiles; j += 2) {
      tile(sa, sb, j, stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      if (j + 1 < n_tiles) {
        tile(sb, sa, j + 1, stage);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    keep(o);
    keep(pa);
    if (lane == 0) bar_arrive(kv_empty + 8 * (stage == 0 ? S - 1 : stage - 1));
    if (++slot == 2) {
      slot = 0;
      slot_phase ^= 1;
    }

    const float l0 = quad_sum(l[0][0] + l[0][1]), l1 = quad_sum(l[1][0] + l[1][1]);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const size_t rows = ((size_t)b * H + h) * (size_t)seq;  // stats row of (b, h, 0)
    if (stats != nullptr && c == 0) {
      // the max in the natural domain; a fully masked row's is the sentinel
      const float m0 = m[0] == -FLT_MAX ? -FLT_MAX : m[0] * kLn2;
      const float m1 = m[1] == -FLT_MAX ? -FLT_MAX : m[1] * kLn2;
      if (row0 + r < seq) *reinterpret_cast<float2*>(stats + 2 * (rows + row0 + r)) = make_float2(m0, l0);
      if (row0 + r + 8 < seq)
        *reinterpret_cast<float2*>(stats + 2 * (rows + row0 + r + 8)) = make_float2(m1, l1);
    }
    // O / l rounded into the warpgroup's swizzled tile; one thread stores it
    if (threadIdx.x % 128 == 0) bulk_wait<true>();  // the last item's store has read it
    named_sync(1 + half, 128);
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {
      st_shared(own + swizzled<W>(r, u) + 4 * c, pack_bf16x2(o[4 * u] * inv0, o[4 * u + 1] * inv0));
      st_shared(own + swizzled<W>(r + 8, u) + 4 * c,
                pack_bf16x2(o[4 * u + 2] * inv1, o[4 * u + 3] * inv1));
    }
    fence_async_shared();
    named_sync(1 + half, 128);
    if (threadIdx.x % 128 == 0 && row0 < seq) {
      tma_store_4d(&map_o, own, 0, row0, h, b);
      bulk_commit();
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<false>();
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_o,
                         const __grid_constant__ CUtensorMap map_mask, float* __restrict__ stats,
                         int H, int seq, float scale, int q_blocks, int items) {
  fwd_bf16<D, false>(map_q, map_k, map_v, map_o, map_mask, map_mask, stats, nullptr, H, seq,
                     scale, q_blocks, items);
}

// ------------------------------------------------------------ f32, CUDA cores

constexpr int kBlockQ = 64;  // query rows a block owns
constexpr int kBlockK = 64;  // keys a tile holds
constexpr int kThreads = 256;  // 16 row groups × 16 column lanes
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;  // key columns tx + 16·c of a score tile
constexpr int kPStride = kBlockK + 1;

template <int D>
constexpr int smem_floats() {
  // Q and K with a one-float pad against bank conflicts, V, P
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kPStride;
}

// The f32 kernel's body; Bias adds g[b, h, q]·table[h, k − q + 128·nb − 1]
// (table rows tab_len apart) to each real, unmasked key's scaled score.
template <int D, bool Bias>
__device__ __forceinline__ void fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const uint8_t* __restrict__ mask, float* __restrict__ o,
                                        float* __restrict__ stats,
                                        const float* __restrict__ table,
                                        const float* __restrict__ gate, int tab_len, int H,
                                        int seq, float scale, HeadStrides in, HeadStrides out) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kOutCols = D / 16;  // output columns tx + 16·j a thread owns

  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBlockQ][D + 1]
  float* Ks = Qs + kBlockQ * (D + 1);  // [kBlockK][D + 1]
  float* Vs = Ks + kBlockK * (D + 1);  // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;        // [kBlockQ][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column lane
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rows = ((size_t)b * H + h) * (size_t)seq;
  const size_t head = in.at(b, h), ohead = out.at(b, h);
  const uint8_t* mrow = mask + (size_t)b * seq;
  // the table's entry of offset key − row is at trow[key − row]
  const float* trow = Bias ? table + (size_t)h * tab_len + tab_len / 2 - 1 : nullptr;
  float grow[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = q0 + ty * kRowsPerThread + r;
    grow[r] = Bias && row < seq ? gate[rows + row] : 0.f;
  }

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    Qs[r * (D + 1) + c] = row < seq ? q[head + (size_t)row * in.row + c] : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[r][j] = 0.f;
  }

  const int n_tiles = (seq + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = k0 + r;
      const bool valid = key < seq;
      Ks[r * (D + 1) + c] = valid ? k[head + (size_t)key * in.row + c] : 0.f;
      Vs[r * D + c] = valid ? v[head + (size_t)key * in.row + c] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float a[kRowsPerThread], bk[kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) a[r] = Qs[(ty * kRowsPerThread + r) * (D + 1) + dd];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) bk[c] = Ks[(tx + 16 * c) * (D + 1) + dd];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

    bool valid[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int key = k0 + tx + 16 * c;
      valid[c] = key < seq;
      const bool masked = valid[c] && mrow[key] != 0;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        float x = s[r][c] * scale;
        if (Bias && valid[c]) x += grow[r] * trow[key - (q0 + ty * kRowsPerThread + r)];
        s[r][c] = !valid[c] ? -INFINITY : (masked ? -FLT_MAX : x);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) tile_max = fmaxf(tile_max, s[r][c]);
      const float m_new = fmaxf(m[r], half_warp_max(tile_max));
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const float p = valid[c] ? expf(s[r][c] - m_new) : 0.f;
        psum += p;
        Ps[(ty * kRowsPerThread + r) * kPStride + tx + 16 * c] = p;
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

    const int k_used = min(kBlockK, seq - k0);
    for (int kk = 0; kk < k_used; ++kk) {
      float vv[kOutCols];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float p = Ps[(ty * kRowsPerThread + r) * kPStride + kk];
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const float lr = half_warp_sum(l[r]);
    const float inv = 1.f / lr;
    const int row = q0 + ty * kRowsPerThread + r;
    if (stats != nullptr && tx == 0 && row < seq)
      *reinterpret_cast<float2*>(stats + 2 * (rows + row)) = make_float2(m[r], lr);
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) o[ohead + (size_t)row * out.row + tx + 16 * j] = acc[r][j] * inv;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ mask,
                        float* __restrict__ o, float* __restrict__ stats, int H, int seq,
                        float scale, HeadStrides in, HeadStrides out) {
  fwd_f32<D, false>(q, k, v, mask, o, stats, nullptr, nullptr, 0, H, seq, scale, in, out);
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  void* o;
  float* stats;
  int B, H, seq;
  float scale;
  HeadStrides in, out;  // q, k, v; o
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a) {
  CUtensorMap mq, mk, mv, mo, mm;
  const HeadStrides& i = a.in;
  const HeadStrides& o = a.out;
  if (!make_head_map(&mq, a.q, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kItemRows) ||
      !make_head_map(&mk, a.k, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileKeys) ||
      !make_head_map(&mv, a.v, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileKeys) ||
      !make_head_map(&mo, a.o, D, a.seq, a.H, a.B, o.row, o.head, o.batch, 64) ||
      !make_byte_map(&mm, a.mask, (long long)a.B * a.seq, kMaskBox))
    return cudaErrorInvalidValue;
  const int q_blocks = (a.seq + kItemRows - 1) / kItemRows;
  const long long items = (long long)a.B * a.H * q_blocks;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = flash_attention_fwd_bf16<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int grid = items < sm_count() ? (int)items : sm_count();
  kernel<<<grid, kWgThreads, Smem<D>::kBytes, a.stream>>>(mq, mk, mv, mo, mm, a.stats, a.H,
                                                            a.seq, a.scale, q_blocks, (int)items);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_attention_fwd_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.o), a.stats, a.H, a.seq,
      a.scale, a.in, a.out);
  return cudaGetLastError();
}

}  // namespace flash_fwd

// ------------------------------------------- the gated relative-position bias

namespace relbias_flash {

using namespace hopper;
using flash_fwd::kItemRows;
using flash_fwd::kTabWindow;
using flash_fwd::kTileKeys;
using flash_fwd::kWgThreads;
using flash_fwd::Smem;

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
relbias_fwd_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                 const __grid_constant__ CUtensorMap map_mask,
                 const __grid_constant__ CUtensorMap map_tab, const float* __restrict__ gate,
                 int H, int seq, float scale, int q_blocks, int items) {
  flash_fwd::fwd_bf16<D, true>(map_q, map_k, map_v, map_o, map_mask, map_tab, nullptr, gate, H,
                               seq, scale, q_blocks, items);
}

template <int D>
__global__ void __launch_bounds__(flash_fwd::kThreads)
relbias_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ o, const float* __restrict__ table,
                const float* __restrict__ gate, int tab_len, int H, int seq, float scale,
                HeadStrides in, HeadStrides out) {
  flash_fwd::fwd_f32<D, true>(q, k, v, mask, o, nullptr, table, gate, tab_len, H, seq, scale,
                              in, out);
}

struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  const float *table, *gate;
  void* o;
  int B, H, seq;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a) {
  CUtensorMap mq, mk, mv, mo, mm, mt;
  const HeadStrides i = contiguous_heads(a.H, a.seq, D);
  const int nb = (a.seq + kTileKeys - 1) / kTileKeys;
  if (!make_head_map(&mq, a.q, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kItemRows) ||
      !make_head_map(&mk, a.k, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileKeys) ||
      !make_head_map(&mv, a.v, D, a.seq, a.H, a.B, i.row, i.head, i.batch, kTileKeys) ||
      !make_head_map(&mo, a.o, D, a.seq, a.H, a.B, i.row, i.head, i.batch, 64) ||
      !make_byte_map(&mm, a.mask, (long long)a.B * a.seq, flash_fwd::kMaskBox) ||
      !make_f32_map(&mt, a.table, (long long)a.H * 2 * kTileKeys * nb, kTabWindow))
    return cudaErrorInvalidValue;
  const long long items = (long long)a.B * a.H * nb;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = relbias_fwd_bf16<D>;
  constexpr int bytes = Smem<D, true>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int grid = items < sm_count() ? (int)items : sm_count();
  kernel<<<grid, kWgThreads, bytes, a.stream>>>(mq, mk, mv, mo, mm, mt, a.gate, a.H, a.seq,
                                                a.scale, nb, (int)items);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = flash_fwd::smem_floats<D>() * sizeof(float);
  auto kernel = relbias_fwd_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const HeadStrides i = contiguous_heads(a.H, a.seq, D);
  const int nb = (a.seq + kTileKeys - 1) / kTileKeys;
  dim3 grid((a.seq + flash_fwd::kBlockQ - 1) / flash_fwd::kBlockQ, a.H, a.B);
  kernel<<<grid, flash_fwd::kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.o), a.table, a.gate,
      2 * kTileKeys * nb, a.H, a.seq, a.scale, i, i);
  return cudaGetLastError();
}

}  // namespace relbias_flash

// The gated relative-position bias variant: q, k, v, o contiguous (B, H, T,
// d), 16-byte aligned; mask contiguous (B, T) bytes; table contiguous f32
// (H, 256·⌈T/128⌉), entry k − q + 128·⌈T/128⌉ − 1 of row h the bias of
// offset k − q; gate contiguous f32 (B, H, T). dtype and head_dim as below.
inline cudaError_t relbias_flash_attention_fwd(const void* q, const void* k, const void* v,
                                               const uint8_t* mask, const float* table,
                                               const float* gate, void* o, int B, int H, int seq,
                                               int head_dim, int dtype, float scale,
                                               cudaStream_t s) {
  using namespace relbias_flash;
  if (B <= 0 || H <= 0 || seq <= 0 || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(table) % 16)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, mask, table, gate, o, B, H, seq, scale, s};
  if (dtype == 0 && head_dim == 32) return launch_f32<32>(a);
  if (dtype == 0 && head_dim == 64) return launch_f32<64>(a);
  if (dtype == 1 && head_dim == 32) return launch_bf16<32>(a);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(a);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t
// (0 = launched); cudaErrorInvalidValue for a shape or type it does not take.
// q, k, v at `in` and o at `out` (see HeadStrides; 16-byte aligned, every
// stride a multiple of 8 elements); mask contiguous (B, T) bytes; stats
// null, or contiguous (B, H, T, 2) f32 to receive each row's (m, l).
inline cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const uint8_t* mask, void* o, float* stats, int B, int H,
                                       int seq, int head_dim, int dtype, float scale,
                                       HeadStrides in, HeadStrides out, cudaStream_t s) {
  using namespace flash_fwd;
  if (B <= 0 || H <= 0 || seq <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const Args a{q, k, v, mask, o, stats, B, H, seq, scale, in, out, s};
  if (dtype == 0 && head_dim == 32) return launch_f32<32>(a);
  if (dtype == 0 && head_dim == 64) return launch_f32<64>(a);
  if (dtype == 1 && head_dim == 32) return launch_bf16<32>(a);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(a);
  return cudaErrorInvalidValue;
}

}  // namespace wavjepa
