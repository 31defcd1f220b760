// The matrix products of the projection-fused attention block
// (fused_attention_block_fwd.cu and fused_attention_block_bwd.cu): the QKV
// and output projections, their input gradients and the weight gradients.
//
//     C[i, j] = Σ_k A(i, k) · B(j, k),   k over [k_begin, k_end)
//
// with f32 sums, then an epilogue that adds a bias and rounds to the input
// type, or writes f32 split-K partials. Operands are read through views of
// the layouts the block already has, so nothing is transposed or copied in
// device memory:
//   * RowMajor: a row-major matrix (x, g, dx, the weights);
//   * Heads: activations split by head, (parts, B, H, T, hd) — row m = (b, t),
//     column (part, h, i) — as the attention kernels read and write q, k, v,
//     o, dO and dq, dk, dv.
// An operand is Along (A(i, k) = view(i, k): contiguous along k) or Across
// (A(i, k) = view(k, i): contiguous along i, for the weight gradients, whose
// k is the token). Either way a 64 × 32 tile is staged in shared memory with
// k contiguous, read 16 bytes at a time from device memory.
//
// Blocks of 128 threads own a 64 × 64 tile of C and step through k in
// slices of 32, loading the next slice into registers while the current one
// is multiplied:
//   * bf16: four warps of 32 × 32, mma.sync m16n8k16 (bf16 in, f32 sum);
//     staged rows padded by 8 values so that fragment loads hit 32 banks;
//   * f32 (parity checks): CUDA-core FMAs, 8 × 4 of C a thread.
// A split-K product (blockIdx.z = chunk of k) writes one f32 partial per
// chunk; sum_partials adds them in chunk order. There are no atomics, so two
// runs give equal bits. TMA and wgmma pipelines are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace wavjepa {
namespace block_gemm {

constexpr int kTile = 64;   // rows and columns of C a block owns
constexpr int kDepth = 32;  // k a stage holds
constexpr int kThreads = 128;

template <typename T>
struct Smem {  // a staged 64 × 32 tile, k contiguous
  // bf16: 8 values of padding keep 16-byte rows and spread fragment loads;
  // f32: one float spreads the FMA loop's column reads
  static constexpr int kStride = sizeof(T) == 2 ? kDepth + 8 : kDepth + 1;
};

// ------------------------------------------------------------------ views

// Element (r, c) at p[r·ld + c].
template <typename E>
struct RowMajor {
  E* p;
  int ld;
  __device__ __forceinline__ E* at(int r, int c) const { return p + (size_t)r * ld + c; }
};

// Row m = (b, t), column c = (part, h, i) of a (parts, B, H, T, hd) tensor.
template <typename E>
struct Heads {
  E* p;
  int batch, heads, seq, hd;
  __device__ __forceinline__ size_t offset(int m, int c) const {
    const int b = m / seq, t = m - b * seq;
    const int dim = heads * hd;
    const int part = c / dim, rest = c - part * dim;
    const int h = rest / hd, i = rest - h * hd;
    return ((((size_t)part * batch + b) * heads + h) * seq + t) * hd + i;
  }
  __device__ __forceinline__ E* at(int m, int c) const { return p + offset(m, c); }
};

// ---------------------------------------------------------------- operands

// Operand (r, k) = view(r, k), rows < `rows`; 16-byte chunks along k.
template <typename T, class View>
struct Along {
  View v;
  int rows;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPerRow = kDepth / kVec;                   // chunks across a row
  static constexpr int kN = kTile * kDepth / kVec / kThreads;     // chunks a thread moves
  struct Regs {
    uint4 x[kN];
  };

  __device__ __forceinline__ void fetch(Regs& r, int r0, int k0, int k_end) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int row = idx / kPerRow, kc = (idx % kPerRow) * kVec;
      r.x[n] = r0 + row < rows && k0 + kc < k_end
                   ? *reinterpret_cast<const uint4*>(v.at(r0 + row, k0 + kc))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(const Regs& r, T* s) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int row = idx / kPerRow, kc = (idx % kPerRow) * kVec;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(&s[row * Smem<T>::kStride + kc]) = r.x[n];
      } else {
        const float* e = reinterpret_cast<const float*>(&r.x[n]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[row * Smem<T>::kStride + kc + j] = e[j];
      }
    }
  }
};

// Operand (r, k) = view(k, r), rows < `rows` (a multiple of 8); 16-byte
// chunks along r. In bf16 a thread moves the chunks of k and k + 1 for the
// same rows and stores them as pairs, the two halves of a fragment register.
template <typename T, class View>
struct Across {
  View v;
  int rows;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPerK = kTile / kVec;                      // chunks across the rows
  static constexpr int kN = kTile * kDepth / kVec / kThreads;     // chunks a thread moves
  struct Regs {
    uint4 x[kN];
  };

  // chunk n of this thread: (depth index, first row)
  __device__ __forceinline__ void chunk(int n, int& kk, int& rc) const {
    if constexpr (sizeof(T) == 2) {  // kN = 2: k pair threadIdx.x / kPerK, k = 2·pair + n
      kk = 2 * (threadIdx.x / kPerK) + n;
      rc = (threadIdx.x % kPerK) * kVec;
    } else {
      const int idx = threadIdx.x + n * kThreads;
      kk = idx / kPerK;
      rc = (idx % kPerK) * kVec;
    }
  }

  __device__ __forceinline__ void fetch(Regs& r, int r0, int k0, int k_end) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      int kk, rc;
      chunk(n, kk, rc);
      r.x[n] = k0 + kk < k_end && r0 + rc < rows
                   ? *reinterpret_cast<const uint4*>(v.at(k0 + kk, r0 + rc))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(const Regs& r, T* s) const {
    if constexpr (sizeof(T) == 2) {
      static_assert(kN == 2, "bf16 stages one k pair a thread");
      int kk, rc;
      chunk(0, kk, rc);
      const __nv_bfloat16* lo = reinterpret_cast<const __nv_bfloat16*>(&r.x[0]);
      const __nv_bfloat16* hi = reinterpret_cast<const __nv_bfloat16*>(&r.x[1]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        __nv_bfloat162 pair;
        pair.x = lo[e];
        pair.y = hi[e];
        *reinterpret_cast<__nv_bfloat162*>(&s[(rc + e) * Smem<T>::kStride + kk]) = pair;
      }
    } else {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        int kk, rc;
        chunk(n, kk, rc);
        const float* e = reinterpret_cast<const float*>(&r.x[n]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[(rc + j) * Smem<T>::kStride + kk] = e[j];
      }
    }
  }
};

// --------------------------------------------------------------- epilogues

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// (C + bias) rounded to T into a row-major matrix; bias (J,) or null.
template <typename T>
struct ToRows {
  T* out;
  int ld;
  const T* bias;
  __device__ __forceinline__ void operator()(int i, int j, float a, float b) const {
    if (bias != nullptr) {
      a += to_f32(bias[j]);
      b += to_f32(bias[j + 1]);
    }
    store_pair(out + (size_t)i * ld + j, a, b);
  }
};

// (C + bias) rounded to T into a Heads layout; bias (J,) or null.
template <typename T>
struct ToHeads {
  Heads<T> dst;
  const T* bias;
  __device__ __forceinline__ void operator()(int i, int j, float a, float b) const {
    if (bias != nullptr) {
      a += to_f32(bias[j]);
      b += to_f32(bias[j + 1]);
    }
    store_pair(dst.at(i, j), a, b);
  }
};

// C in f32 as split-K partial blockIdx.z: out[z·stride + i·ld + j].
struct ToPartial {
  float* out;
  int ld;
  size_t stride;
  __device__ __forceinline__ void operator()(int i, int j, float a, float b) const {
    store_pair(out + blockIdx.z * stride + (size_t)i * ld + j, a, b);
  }
};

// ------------------------------------------------------------------ kernel

// C (I × J) over k in [z·chunk, min(K, (z + 1)·chunk)) for z = blockIdx.z.
// J must be even (the epilogue writes column pairs). When `bias_sum` is not
// null, the blocks of the first row tile also sum B over k per column j
// (the bias gradient of a weight gradient) into bias_sum[z·bias_stride + j].
template <typename T, class OpA, class OpB, class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(OpA a, OpB b, Epi epi, int I, int J, int K, int chunk, float* bias_sum,
            size_t bias_stride) {
  constexpr int S = Smem<T>::kStride;
  __shared__ __align__(16) T As[kTile * S];
  __shared__ __align__(16) T Bs[kTile * S];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const int k_begin = blockIdx.z * chunk, k_end = min(K, k_begin + chunk);
  const bool sums = bias_sum != nullptr && blockIdx.x == 0;

  // bf16: warp (wm, wn) owns rows 32·wm.., columns 32·wn..; lane = 4·g + c
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, c = lane & 3;
  // f32: rows 8·ty + r, columns 2·tx + e + 32·q
  const int tx = tid & 15, ty = tid >> 4;

  float acc[2][4][4];  // bf16: [m16 tile][n8 tile][fragment]; f32: [q][e][..] below
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[x][y][z] = 0.f;
  float bsum = 0.f;

  typename OpA::Regs ra;
  typename OpB::Regs rb;
  if (k_begin < k_end) {
    a.fetch(ra, i0, k_begin, k_end);
    b.fetch(rb, j0, k_begin, k_end);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kDepth) {
    __syncthreads();  // the previous slice is consumed
    a.store(ra, As);
    b.store(rb, Bs);
    __syncthreads();
    if (k0 + kDepth < k_end) {  // in flight while this slice is multiplied
      a.fetch(ra, i0, k0 + kDepth, k_end);
      b.fetch(rb, j0, k0 + kDepth, k_end);
    }
    if (sums && tid < kTile) {
#pragma unroll 8
      for (int k = 0; k < kDepth; ++k) bsum += to_f32(Bs[tid * S + k]);
    }
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int ks = 0; ks < kDepth; ks += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* p = &As[(32 * wm + 16 * mt + g) * S + ks + 2 * c];
          af[mt][0] = load_u32(p);
          af[mt][1] = load_u32(p + 8 * S);
          af[mt][2] = load_u32(p + 8);
          af[mt][3] = load_u32(p + 8 * S + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const T* p = &Bs[(32 * wn + 8 * nt + g) * S + ks + 2 * c];
          const uint32_t b0 = load_u32(p), b1 = load_u32(p + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_16x8x16(acc[mt][nt], af[mt], b0, b1);
        }
      }
    } else {
      // acc[r / 4][r % 4][2·q + e] holds row 8·ty + r, column 2·tx + e + 32·q
#pragma unroll 4
      for (int k = 0; k < kDepth; ++k) {
        float x[8], y[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) x[r] = As[(8 * ty + r) * S + k];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) y[2 * q + e] = Bs[(2 * tx + e + 32 * q) * S + k];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[r / 4][r % 4][n] = fmaf(x[r], y[n], acc[r / 4][r % 4][n]);
      }
    }
  }

  if (sums && tid < kTile && j0 + tid < J) bias_sum[blockIdx.z * bias_stride + j0 + tid] = bsum;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = i0 + 32 * wm + 16 * mt + g, j = j0 + 32 * wn + 8 * nt + 2 * c;
        if (j < J) {
          if (i < I) epi(i, j, acc[mt][nt][0], acc[mt][nt][1]);
          if (i + 8 < I) epi(i + 8, j, acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + 8 * ty + r;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = j0 + 2 * tx + 32 * q;
        if (i < I && j < J) epi(i, j, acc[r / 4][r % 4][2 * q], acc[r / 4][r % 4][2 * q + 1]);
      }
    }
  }
}

// out[e] = Σ_z part[z·n + e] over z = 0 .. splits − 1, in that order.
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ out, int splits,
                             size_t n) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + e];
    out[e] = s;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Launch C = A·Bᵀ over K split into `splits` chunks of whole slices.
template <typename T, class OpA, class OpB, class Epi>
cudaError_t gemm(const OpA& a, const OpB& b, const Epi& epi, int I, int J, int K, int splits,
                 float* bias_sum, size_t bias_stride, cudaStream_t stream) {
  const int chunk = ceil_div(ceil_div(K, splits), kDepth) * kDepth;
  const dim3 grid(ceil_div(I, kTile), ceil_div(J, kTile), splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  gemm_kernel<T, OpA, OpB, Epi><<<grid, kThreads, 0, stream>>>(a, b, epi, I, J, K, chunk,
                                                               bias_sum, bias_stride);
  return cudaGetLastError();
}

inline cudaError_t reduce_partials(const float* part, float* out, int splits, size_t n,
                                   cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_partials<<<blocks, 256, 0, stream>>>(part, out, splits, n);
  return cudaGetLastError();
}

}  // namespace block_gemm
}  // namespace wavjepa
