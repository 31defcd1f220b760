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
// nothing is transposed in registers or in device memory.
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

namespace wavjepa {
namespace hopper_gemm {

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

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// box (c0, c1) of a 2-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a box of shared memory (c0, c1) into a 2-D tensor map's matrix, in the
// block's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the block's bulk stores have read their shared memory (Read) or are done
template <bool Read>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (Read)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// barrier `id` over the 128 threads of a warpgroup
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte swizzled layout:
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of k-step s (16 values of k) of a 64-row block at `base`.
// K-major: rows of 128 bytes, 8-row groups 1024 bytes apart, k advances
// 32 bytes. MN-major: one 128-byte row per k, 64 rows a block (kChunk
// bytes, the next 64 of the rows kChunk further: the leading offset), 8-k
// groups 1024 bytes apart, k advances 16 rows.
template <int Trans>
__device__ __forceinline__ uint64_t step_desc(uint32_t base, int s) {
  return Trans ? smem_desc(base + 2048 * s, kChunk, 1024) : smem_desc(base + 32 * s, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define ACC8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 × N, f32, registers) += A (64 × 16) · B (N × 16)ᵀ, both from shared
// memory through descriptors; TA / TB = 1 for an MN-major operand. The sums'
// layout: warp w of the warpgroup, lane 4·g + c, holds d[4j], d[4j+1] at row
// 16w + g, columns 8j + 2c, +1, and d[4j+2], d[4j+3] at row 16w + g + 8.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56), ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56), ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88), ACC8(d, 96), ACC8(d, 104), ACC8(d, 112), ACC8(d, 120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


#undef ACC8

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128<TA, TB>(d, da, db);
  else if constexpr (BN == 192) wgmma_n192<TA, TB>(d, da, db);
  else wgmma_n256<TA, TB>(d, da, db);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no link flag for libcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A row-major bf16 matrix (outer rows of `inner` values, ld apart) cut in
// boxes of box_inner × box_outer, 128-byte swizzled, zeros past its edges.
inline bool make_map(CUtensorMap* map, const void* p, int inner, int outer, int ld, int box_inner,
                     int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(p) % 16 || ld % 8) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

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
