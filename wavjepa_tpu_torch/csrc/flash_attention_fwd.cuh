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
// tensor cores, not its memory, are the limit: at the windowed T=200 the
// kernel is bound by bytes (~100 a byte), at the whole-clip T=999 by
// operations (~500 a byte).
//
// What the design does about that. The TPU kernel keeps the whole (H, T, T)
// f32 score block in VMEM; at T=999 that is 48 MB for 12 heads, and Hopper
// gives a block 227 KB. Here a block owns 64 query rows of one (batch, head)
// and walks the keys in tiles of 64: each K and V tile is staged once in
// shared memory, the 64×64 score tile lives in registers, and a running max
// and sum per row rescale the f32 accumulator, so nothing of size T² reaches
// device memory and q, k, v are read from it once per query block.
//   * bf16 (serving): four warps, 16 query rows each, run both products on
//     the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The
//     score fragments become, rounded to bf16, the A operand of P·V in
//     registers; K is staged row-major and V transposed, each row padded by
//     8 values so that the fragment loads hit 32 distinct banks. Tiles that
//     overlap their loads with the products (cp.async or TMA, wgmma) are the
//     next step.
//   * f32 (parity checks): 256 threads of CUDA-core FMAs, 4×4 scores each.
//
// Two sentinels, on purpose. A masked key gets the finite f32 minimum, as
// the JAX kernel does: a row whose keys are all masked then gets uniform
// weights over the T real keys, never NaN. A slot past T in the last key
// tile is not a key at all: it gets −inf, stays out of the max and gets
// weight 0, so it cannot join the uniform average of a fully masked row.
//
// Row statistics for the backward. When `stats` is not null the kernel also
// writes, per query row, the final running max m and sum l of exp(s − m) as
// an f32 pair (B, H, T, 2); flash_attention_bwd.cuh rebuilds P = exp(s − m)/l
// from them. Not a single logsumexp: for a fully masked row m is −FLT_MAX
// and m + log(l) rounds back to −FLT_MAX, which would give that row weights
// of 1 instead of 1/T. The serving path passes null and writes nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace wavjepa {
namespace flash_fwd {

constexpr int kBlockQ = 64;  // query rows a block owns
constexpr int kBlockK = 64;  // keys a tile holds

// ---------------------------------------------------------------- bf16, mma

constexpr int kMmaWarps = kBlockQ / 16;  // one warp per 16 query rows
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPad = 8;  // bf16 values of padding at the end of a K or Vᵀ row

// Fragment layouts: see mma_16x8x16 in attention_common.cuh.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ stats, int H,
                         int seq, float scale, HeadStrides in, HeadStrides out) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KS = D + kPad;        // K row stride
  constexpr int VS = kBlockK + kPad;  // Vᵀ row stride
  constexpr int kDSteps = D / 16;     // k-steps of Q·Kᵀ
  constexpr int kNTiles = kBlockK / 8;
  constexpr int kOTiles = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockK * KS];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VS];
  __shared__ uint8_t Ms[kBlockK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = blockIdx.x * kBlockQ + (tid >> 5) * 16 + g;  // and row0 + 8
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rows = ((size_t)b * H + h) * (size_t)seq;  // first row of this (b, h)
  const size_t head = in.at(b, h), ohead = out.at(b, h);
  const uint8_t* mrow = mask + (size_t)b * seq;
  const bool in0 = row0 < seq, in1 = row0 + 8 < seq;

  // the warp's 16 query rows, all of d, as A fragments
  uint32_t qa[kDSteps][4];
  load_a_rows<D>(qa, q + head, in.row, row0, in0, in1, c);

  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (seq + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    constexpr int kChunks = kBlockK * D / 8;  // 16-byte chunks of a tile
    const size_t tile = head + (size_t)k0 * in.row;  // in-tile offsets fit an int
    for (int i = tid; i < kChunks; i += kMmaThreads) {
      const int r = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < seq) {
        kv = *reinterpret_cast<const uint4*>(k + tile + (r * in.row + col));
        vv = *reinterpret_cast<const uint4*>(v + tile + (r * in.row + col));
      }
      *reinterpret_cast<uint4*>(&Ks[r * KS + col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(col + e) * VS + r] = ve[e];
    }
    for (int i = tid; i < kBlockK; i += kMmaThreads) Ms[i] = k0 + i < seq ? mrow[k0 + i] : 0;
    __syncthreads();

    // S = Q Kᵀ for 16 rows × 64 keys
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        const __nv_bfloat16* kp = &Ks[(nt * 8 + g) * KS + ks * 16 + 2 * c];
        mma_16x8x16(s[nt], qa[ks], load_u32(kp), load_u32(kp + 8));
      }
    }

    // sentinels and scale, then the online softmax of rows g (e < 2), g+8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * c + (e & 1);
        const float x = k0 + col >= seq ? -INFINITY : (Ms[col] ? -FLT_MAX : s[nt][e] * scale);
        s[nt][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // every tile holds at least one key < T, so m_new is finite
      const float m_new = fmaxf(m[i], quad_max(tmax[i]));
      alpha[i] = expf(m[i] - m_new);  // exp(-inf) = 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // P, rounded to bf16: score tiles 2j and 2j+1 are the A fragment of
    // keys 16j..16j+15 for P·V
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + nt * 8 + 2 * c + (e & 1) < seq;
        p[e] = valid ? expf(s[nt][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p[e];
      }
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int j = 0; j < kNTiles / 2; ++j) {
#pragma unroll
      for (int dt = 0; dt < kOTiles; ++dt) {
        const __nv_bfloat16* vp = &Vt[(dt * 8 + g) * VS + j * 16 + 2 * c];
        mma_16x8x16(acc[dt], pa[j], load_u32(vp), load_u32(vp + 8));
      }
    }
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (stats != nullptr && c == 0) {
    if (in0) *reinterpret_cast<float2*>(stats + 2 * (rows + row0)) = make_float2(m[0], l0);
    if (in1) *reinterpret_cast<float2*>(stats + 2 * (rows + row0 + 8)) = make_float2(m[1], l1);
  }
#pragma unroll
  for (int dt = 0; dt < kOTiles; ++dt) {
    const int col = dt * 8 + 2 * c;
    if (in0)
      *reinterpret_cast<uint32_t*>(o + ohead + (size_t)row0 * out.row + col) =
          pack_bf16x2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (in1)
      *reinterpret_cast<uint32_t*>(o + ohead + (size_t)(row0 + 8) * out.row + col) =
          pack_bf16x2(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ------------------------------------------------------------ f32, CUDA cores

constexpr int kThreads = 256;  // 16 row groups × 16 column lanes
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;  // key columns tx + 16·c of a score tile
constexpr int kPStride = kBlockK + 1;

template <int D>
constexpr int smem_floats() {
  // Q and K with a one-float pad against bank conflicts, V, P
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kPStride;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ mask,
                        float* __restrict__ o, float* __restrict__ stats, int H, int seq,
                        float scale, HeadStrides in, HeadStrides out) {
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
        s[r][c] = !valid[c] ? -INFINITY : (masked ? -FLT_MAX : s[r][c] * scale);
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
  dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_attention_fwd_bf16<D><<<grid, kMmaThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, static_cast<__nv_bfloat16*>(a.o), a.stats,
      a.H, a.seq, a.scale, a.in, a.out);
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

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t
// (0 = launched); cudaErrorInvalidValue for a shape or type it does not take.
// q, k, v at `in` and o at `out` (see HeadStrides; rows 16-byte aligned);
// mask contiguous (B, T) bytes; stats null, or contiguous (B, H, T, 2) f32
// to receive each row's (m, l).
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
