// The bf16 matrix products of the projection-fused attention block
// (fused_attention_block_fwd.cu and fused_attention_block_bwd.cu) on
// Hopper's asynchronous units:
//
//     C[i, j] = Σ_k A(i, k) · B(j, k),   k over one split-K chunk
//
// with f32 sums in registers, then an epilogue that adds a bias and rounds
// once to bf16, or writes an f32 split-K partial. Every operand is a plain
// row-major bf16 matrix in device memory, read in one of two orders:
//   * K-major (TA or TB = 0): stored (rows, K), K contiguous — x, o, g, the
//     activations along their features, the weights as torch keeps them;
//   * MN-major (1): stored (K, rows), rows contiguous — the weight
//     gradients, whose k is the token (dW_in = dqkvᵀ·x, dWo = gᵀ·o), and the
//     weights read across (dO = g·Wo, dx = dqkv·W_in).
// wgmma reads both orders from shared memory (its transpose bits), so
// nothing is transposed in registers or in device memory. The barriers, TMA,
// wgmma and tensor-map helpers are hopper_common.cuh's, shared with the
// flash-attention kernels.
//
// What bounds a product on an H100. 2·M·N·K operations over the operands
// read once and C written once: at the block's widths (K = 384 .. 3072)
// that is 250-1000 operations a byte, at or above the ~295 where the tensor
// cores, not the memory, are the limit. So the design feeds the tensor cores
// without stalls:
//   * one block per SM, persistent: it walks output tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...; a tile is 128 × BN (BN 128, 192 or 256,
//     chosen by the caller so that N divides evenly and the tiles fill the
//     card), k in slices of 64 (one 128-byte swizzle row of bf16);
//   * one producer thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle, zeros past the matrix edges) into a ring of 3-6 stages of
//     shared memory, each tracked by a "full" and an "empty" mbarrier; it
//     runs ahead into the next tile while the consumers finish this one;
//   * two consumer warpgroups, 64 rows of the tile each, run
//     wgmma.mma_async m64nBNk16 on every arrived stage, keep one group of
//     products in flight and release a stage as soon as its products are
//     done; setmaxnreg moves registers from the producer's warpgroup to
//     theirs (the BN/2 f32 sums a thread holds);
//   * the epilogue adds the bias and rounds to bf16 into a swizzled tile of
//     shared memory that a TMA store writes out while the warpgroups go on
//     to their next tile (split-K partials go straight from the registers).
//     Rows past M and columns past N are dropped.
// A split-K product (the weight gradients) owns a fixed chunk of k per tile
// index, one f32 partial per chunk; block_gemm.cuh's sum_partials adds them
// in chunk order. No atomics: two runs give equal bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace wavjepa {
namespace hopper_gemm {

using namespace hopper;  // the PTX helpers and tensor maps (hopper_common.cuh)

constexpr int kBM = 128;       // rows of C a tile holds (two warpgroups of 64)
constexpr int kBK = 64;        // k a stage holds: 128 bytes of bf16, one swizzle row
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int kChunk = 64 * kBK * 2;  // bytes of one 64-row, 64-k swizzled block

// Shared memory of a block: the ring of stages, then (Staged) the output
// tile in bf16 for the TMA store, then the full and empty barriers, plus
// room to align to 1024 bytes; 3-6 stages, as many as fit.
template <int BN, bool Staged>
struct Tile {
  static_assert(BN == 128 || BN == 192 || BN == 256, "tile width 128, 192 or 256");
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  static constexpr int kCBytes = Staged ? kBM * BN * 2 : 0;
  static constexpr int kStages =
      Staged ? (BN == 128 ? 6 : BN == 192 ? 4 : 3) : (BN == 128 ? 6 : BN == 192 ? 5 : 4);
  static constexpr int kSmem = kStages * kStageBytes + kCBytes + 2 * kStages * 8 + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// ------------------------------------------------------------ tile layout

// The descriptor of k-step s (16 values of k) of a 64-row block at `base`.
// K-major: rows of 128 bytes, 8-row groups 1024 bytes apart, k advances
// 32 bytes. MN-major: one 128-byte row per k, 64 rows a block (kChunk
// bytes, the next 64 of the rows kChunk further: the leading offset), 8-k
// groups 1024 bytes apart, k advances 16 rows.
template <int Trans>
__device__ __forceinline__ uint64_t step_desc(uint32_t base, int s) {
  return Trans ? smem_desc(base + 2048 * s, kChunk, 1024) : smem_desc(base + 32 * s, 16, 1024);
}

// --------------------------------------------------------------- epilogues

// (C + bias) rounded to bf16 into a row-major matrix (out, rows ld apart);
// bias (N,) or null. Staged: each consumer warpgroup writes its 64 rows of
// the tile into shared memory, 128-byte swizzled as the TMA store reads
// them (no bank conflicts), and one thread stores them with TMA, which
// drops rows past M and columns past N; the warpgroup goes on to its next
// tile's products while the store runs.
struct ToBf16 {
  static constexpr bool kStaged = true;
  __nv_bfloat16* out;
  int ld;
  const __nv_bfloat16* bias;
};

// C in f32 as split-K partial z: out[z·stride + i·ld + j], written from the
// sums' registers.
struct ToPartial {
  static constexpr bool kStaged = false;
  float* out;
  int ld;
  size_t stride;
  __device__ __forceinline__ void operator()(int i, int j, int z, float a, float b) const {
    *reinterpret_cast<float2*>(out + z * stride + (size_t)i * ld + j) = make_float2(a, b);
  }
};

// ------------------------------------------------------------------ kernel

struct Shape {
  int M, N, K, chunk;           // C is M × N; split z sums k in [z·chunk, (z+1)·chunk) ∩ [0, K)
  int tiles_m, tiles_n, tiles;  // tiles = tiles_m · tiles_n · splits
};

// Tile t: column tile fastest (neighbouring blocks share A's rows in L2),
// then row tile, then split.
template <int BN>
__device__ __forceinline__ void tile_at(const Shape& s, int t, int& m0, int& n0, int& z, int& k0,
                                        int& nk) {
  const int nt = t % s.tiles_n, rest = t / s.tiles_n;
  m0 = (rest % s.tiles_m) * kBM;
  n0 = nt * BN;
  z = rest / s.tiles_m;
  k0 = z * s.chunk;
  const int k_end = min(s.K, k0 + s.chunk);
  nk = k_end > k0 ? (k_end - k0 + kBK - 1) / kBK : 0;
}

template <int BN, int TA, int TB, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_c, const Epi epi, const Shape shape) {
  using T = Tile<BN, Epi::kStaged>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t staged = base + S * T::kStageBytes;            // the output tile (Staged)
  const uint32_t full = staged + T::kCBytes, empty = full + 8 * S;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + 8 * s, 1);   // the producer's expect_tx, then the bytes
      bar_init(empty + 8 * s, 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < shape.tiles; t += gridDim.x) {
        int m0, n0, z, k0, nk;
        tile_at<BN>(shape, t, m0, n0, z, k0, nk);
        for (int kb = 0; kb < nk; ++kb, k0 += kBK) {
          bar_wait(empty + 8 * stage, phase ^ 1);  // the first pass finds every stage free
          const uint32_t bar = full + 8 * stage;
          bar_expect_tx(bar, T::kStageBytes);
          const uint32_t a = base + stage * T::kStageBytes, b = a + T::kABytes;
          if constexpr (TA == 0) {
            tma_load(a, &map_a, bar, k0, m0);
          } else {
            tma_load(a, &map_a, bar, m0, k0);
            tma_load(a + kChunk, &map_a, bar, m0 + 64, k0);
          }
          if constexpr (TB == 0) {
            tma_load(b, &map_b, bar, k0, n0);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c) tma_load(b + c * kChunk, &map_b, bar, n0 + 64 * c, k0);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;  // rows 64·half .. of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    int stage = 0, phase = 0;
    float acc[BN / 2];
    for (int t = blockIdx.x; t < shape.tiles; t += gridDim.x) {
      int m0, n0, z, k0, nk;
      tile_at<BN>(shape, t, m0, n0, z, k0, nk);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb) {
        bar_wait(full + 8 * stage, phase);
        const uint32_t a = base + stage * T::kStageBytes + half * kChunk;
        const uint32_t b = base + stage * T::kStageBytes + T::kABytes;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kBK / 16; ++s)
          wgmma<BN, TA, TB>(acc, step_desc<TA>(a, s), step_desc<TB>(b, s));
        wgmma_commit();
        if (prev >= 0) {  // the previous stage's products are done: free it
          wgmma_wait<1>();
          if (lane == 0) bar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) bar_arrive(empty + 8 * prev);

      if constexpr (Epi::kStaged) {
        // rows r = 16·warp + g and r + 8 of this warpgroup's 64; column
        // 8j + 2c lies in 64-column block j / 8, 16-byte unit j % 8, which
        // the 128-byte swizzle moves to unit (j % 8) ^ (r % 8), r % 8 = g
        const uint32_t own = staged + half * (64 * BN * 2);
        const uint32_t row = own + (16 * warp + g) * 128 + 4 * c;
        if (threadIdx.x % 128 == 0) bulk_wait<true>();  // the last tile's store has read it
        named_sync(1 + half);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * c;
          float b0 = 0.f, b1 = 0.f;
          if (epi.bias != nullptr && col < shape.N) {
            b0 = __bfloat162float(epi.bias[col]);
            b1 = __bfloat162float(epi.bias[col + 1]);
          }
          const uint32_t at = row + (j / 8) * kChunk + (((j % 8) ^ g) << 4);
          st_shared(at, pack_bf16x2(acc[4 * j] + b0, acc[4 * j + 1] + b1));
          st_shared(at + 8 * 128, pack_bf16x2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
        named_sync(1 + half);
        if (threadIdx.x % 128 == 0) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_store(&map_c, own + q * kChunk, n0 + 64 * q, m0 + 64 * half);
          bulk_commit();
        }
      } else {
        const int i = m0 + 64 * half + 16 * warp + g;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * c;
          if (col < shape.N) {
            if (i < shape.M) epi(i, col, z, acc[4 * j], acc[4 * j + 1]);
            if (i + 8 < shape.M) epi(i + 8, col, z, acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
      }
    }
    if (Epi::kStaged && threadIdx.x % 128 == 0) bulk_wait<false>();
  }
}

// ------------------------------------------------------------------- host

// One product at tile width BN. A is (M, K) with TA = 0 or (K, M) with
// TA = 1, lda apart; B likewise (N, K) or (K, N). K is cut into `splits`
// chunks of whole 64-k slices.
template <int BN, int TA, int TB, class Epi>
cudaError_t launch(const void* a, int lda, const void* b, int ldb, const Epi& epi, int M, int N,
                   int K, int splits, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || N % 2) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_c = {};
  if (!make_map(&map_a, a, TA ? M : K, TA ? K : M, lda, kBK, TA ? 64 : kBM) ||
      !make_map(&map_b, b, TB ? N : K, TB ? K : N, ldb, kBK, TB ? 64 : BN))
    return cudaErrorInvalidValue;
  if constexpr (Epi::kStaged) {
    if (!make_map(&map_c, epi.out, N, M, epi.ld, 64, 64)) return cudaErrorInvalidValue;
  }
  Shape s;
  s.M = M;
  s.N = N;
  s.K = K;
  s.chunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  s.tiles_m = (M + kBM - 1) / kBM;
  s.tiles_n = (N + BN - 1) / BN;
  const long long tiles = (long long)s.tiles_m * s.tiles_n * splits;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  s.tiles = (int)tiles;
  auto kernel = gemm_kernel<BN, TA, TB, Epi>;
  constexpr int smem = Tile<BN, Epi::kStaged>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = s.tiles < sm_count() ? s.tiles : sm_count();
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_b, map_c, epi, s);
  return cudaGetLastError();
}

// The widest tile in {256, 192, 128} that divides N and still gives every
// SM a tile; 128 when none does.
inline int pick_width(int M, int N, int splits) {
  for (int bn : {256, 192}) {
    if (N % bn == 0 && (long long)((M + kBM - 1) / kBM) * (N / bn) * splits >= sm_count()) return bn;
  }
  return 128;
}

// C = A·Bᵀ (as `launch` reads A and B) at the tile width pick_width chooses;
// Wide = false keeps to 128 (the weight gradients, whose few output tiles
// need every split to fill the card, and fewer kernels to compile).
template <int TA, int TB, bool Wide = true, class Epi>
cudaError_t gemm(const void* a, int lda, const void* b, int ldb, const Epi& epi, int M, int N,
                 int K, int splits, cudaStream_t stream) {
  if constexpr (Wide) {
    const int bn = pick_width(M, N, splits);
    if (bn == 256) return launch<256, TA, TB>(a, lda, b, ldb, epi, M, N, K, splits, stream);
    if (bn == 192) return launch<192, TA, TB>(a, lda, b, ldb, epi, M, N, K, splits, stream);
  }
  return launch<128, TA, TB>(a, lda, b, ldb, epi, M, N, K, splits, stream);
}

}  // namespace hopper_gemm
}  // namespace wavjepa
