// The f32 matrix products of the projection-fused attention block (parity
// checks only; bf16 runs on hopper_gemm.cuh), and the reductions both types
// share: split-K partials summed in order, and column sums.
//
//     C[i, j] = Σ_k A(i, k) · B(j, k),   k over [k_begin, k_end)
//
// with f32 sums, then an epilogue that adds a bias, or writes f32 split-K
// partials. Operands are row-major matrices read Along (A(i, k) = view(i,
// k): contiguous along k) or Across (A(i, k) = view(k, i): contiguous along
// i, for the products whose k is the token). Either way a 64 × 32 tile is
// staged in shared memory with k contiguous, read 16 bytes at a time.
//
// Blocks of 128 threads own a 64 × 64 tile of C and step through k in
// slices of 32 with CUDA-core FMAs, 8 × 4 of C a thread, loading the next
// slice into registers while the current one is multiplied. A split-K
// product (blockIdx.z = chunk of k) writes one f32 partial per chunk;
// sum_partials adds them in chunk order. There are no atomics, so two runs
// give equal bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wavjepa {
namespace block_gemm {

constexpr int kTile = 64;   // rows and columns of C a block owns
constexpr int kDepth = 32;  // k a stage holds
constexpr int kThreads = 128;
constexpr int kStride = kDepth + 1;  // one float of padding spreads the FMA loop's column reads
constexpr int kVec = 4;              // floats in 16 bytes

// Element (r, c) at p[r·ld + c].
struct RowMajor {
  const float* p;
  int ld;
  __device__ __forceinline__ const float* at(int r, int c) const { return p + (size_t)r * ld + c; }
};

// Operand (r, k) = view(r, k), rows < `rows`; 16-byte chunks along k.
struct Along {
  RowMajor v;
  int rows;
  static constexpr int kPerRow = kDepth / kVec;
  static constexpr int kN = kTile * kDepth / kVec / kThreads;  // chunks a thread moves
  struct Regs {
    float4 x[kN];
  };

  __device__ __forceinline__ void fetch(Regs& r, int r0, int k0, int k_end) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int row = idx / kPerRow, kc = (idx % kPerRow) * kVec;
      r.x[n] = r0 + row < rows && k0 + kc < k_end
                   ? *reinterpret_cast<const float4*>(v.at(r0 + row, k0 + kc))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(const Regs& r, float* s) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int row = idx / kPerRow, kc = (idx % kPerRow) * kVec;
      const float* e = reinterpret_cast<const float*>(&r.x[n]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[row * kStride + kc + j] = e[j];
    }
  }
};

// Operand (r, k) = view(k, r), rows < `rows` (a multiple of 4); 16-byte
// chunks along r.
struct Across {
  RowMajor v;
  int rows;
  static constexpr int kPerK = kTile / kVec;
  static constexpr int kN = kTile * kDepth / kVec / kThreads;
  struct Regs {
    float4 x[kN];
  };

  __device__ __forceinline__ void fetch(Regs& r, int r0, int k0, int k_end) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int kk = idx / kPerK, rc = (idx % kPerK) * kVec;
      r.x[n] = k0 + kk < k_end && r0 + rc < rows
                   ? *reinterpret_cast<const float4*>(v.at(k0 + kk, r0 + rc))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(const Regs& r, float* s) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int kk = idx / kPerK, rc = (idx % kPerK) * kVec;
      const float* e = reinterpret_cast<const float*>(&r.x[n]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[(rc + j) * kStride + kk] = e[j];
    }
  }
};

// C + bias into a row-major matrix; bias (J,) or null.
struct ToRows {
  float* out;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(int i, int j, float a, float b) const {
    if (bias != nullptr) {
      a += bias[j];
      b += bias[j + 1];
    }
    *reinterpret_cast<float2*>(out + (size_t)i * ld + j) = make_float2(a, b);
  }
};

// C as split-K partial blockIdx.z: out[z·stride + i·ld + j].
struct ToPartial {
  float* out;
  int ld;
  size_t stride;
  __device__ __forceinline__ void operator()(int i, int j, float a, float b) const {
    *reinterpret_cast<float2*>(out + blockIdx.z * stride + (size_t)i * ld + j) = make_float2(a, b);
  }
};

// C (I × J) over k in [z·chunk, min(K, (z + 1)·chunk)) for z = blockIdx.z;
// J even (the epilogue writes column pairs).
template <class OpA, class OpB, class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(OpA a, OpB b, Epi epi, int I, int J, int K, int chunk) {
  __shared__ __align__(16) float As[kTile * kStride];
  __shared__ __align__(16) float Bs[kTile * kStride];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const int k_begin = blockIdx.z * chunk, k_end = min(K, k_begin + chunk);
  const int tx = tid & 15, ty = tid >> 4;  // rows 8·ty + r, columns 2·tx + e + 32·q

  float acc[8][4];  // [r][2·q + e]
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[r][n] = 0.f;

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
#pragma unroll 4
    for (int k = 0; k < kDepth; ++k) {
      float x[8], y[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = As[(8 * ty + r) * kStride + k];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) y[2 * q + e] = Bs[(2 * tx + e + 32 * q) * kStride + k];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[r][n] = fmaf(x[r], y[n], acc[r][n]);
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 8 * ty + r;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = j0 + 2 * tx + 32 * q;
      if (i < I && j < J) epi(i, j, acc[r][2 * q], acc[r][2 * q + 1]);
    }
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Launch C = A·Bᵀ over K split into `splits` chunks of whole slices.
template <class OpA, class OpB, class Epi>
cudaError_t gemm(const OpA& a, const OpB& b, const Epi& epi, int I, int J, int K, int splits,
                 cudaStream_t stream) {
  const int chunk = ceil_div(ceil_div(K, splits), kDepth) * kDepth;
  const dim3 grid(ceil_div(I, kTile), ceil_div(J, kTile), splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  gemm_kernel<OpA, OpB, Epi><<<grid, kThreads, 0, stream>>>(a, b, epi, I, J, K, chunk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- reductions

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

inline cudaError_t reduce_partials(const float* part, float* out, int splits, size_t n,
                                   cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_partials<<<blocks, 256, 0, stream>>>(part, out, splits, n);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

constexpr int kSumRows = 16;  // row phases of a column-sum block

// out[z·stride + j] = Σ x[i, j] over the rows i of chunk z (blockIdx.y) of a
// row-major (M, N) matrix, N a multiple of 16 bytes' values. A thread sums
// 16 bytes of columns over every kSumRows-th row in order, then the row
// phases are added in order: the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(32 * kSumRows)
column_sums(const T* __restrict__ x, int M, int N, int chunk, float* __restrict__ out,
            size_t stride) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[kSumRows][32 * V];
  const int j = (blockIdx.x * 32 + threadIdx.x) * V;
  const int r_begin = blockIdx.y * chunk, r_end = min(M, r_begin + chunk);
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  if (j < N) {
#pragma unroll 4
    for (int r = r_begin + threadIdx.y; r < r_end; r += kSumRows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)r * N + j);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] += to_f32(e[k]);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[threadIdx.y][threadIdx.x * V + e] = s[e];
  __syncthreads();
  for (int c = threadIdx.y * 32 + threadIdx.x; c < 32 * V; c += 32 * kSumRows) {
    const int col = blockIdx.x * 32 * V + c;
    if (col < N) {
      float t = 0.f;
      for (int y = 0; y < kSumRows; ++y) t += part[y][c];
      out[blockIdx.y * stride + col] = t;
    }
  }
}

// Column sums of each of `splits` row chunks, as a split-K product cuts k.
template <typename T>
cudaError_t sum_columns(const T* x, int M, int N, int splits, float* out, size_t stride,
                        cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (N % V || splits > 65535) return cudaErrorInvalidValue;
  const int chunk = ceil_div(M, splits);
  const dim3 grid(ceil_div(N, 32 * V), splits);
  column_sums<T><<<grid, dim3(32, kSumRows), 0, stream>>>(x, M, N, chunk, out, stride);
  return cudaGetLastError();
}

}  // namespace block_gemm
}  // namespace wavjepa
