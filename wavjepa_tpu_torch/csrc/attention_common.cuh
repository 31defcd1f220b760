// Helpers shared by the attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): bf16 packing, the reductions over the lanes that
// share a row, 2^x, a key's sentinel, and the per-head strides.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace wavjepa {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// max / sum over the four lanes of a quad, which share two rows of a fragment
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// max / sum over the 16 lanes of a half warp that share one row group
__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 2^x on the special function unit (relative error about 2^-22, denormal
// results flushed to 0; 2^-inf = 0). The bf16 kernels take P = 2^(x − m) in
// the log2 domain, and round P to bf16 (2^-8) anyway.
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The additive term of a score whose key is `key`, with mask byte `masked`:
// fmaf(s, scale, bias) is s·scale rounded once (bias 0), the finite f32
// minimum for a masked key (s·scale is far below its last place), and −inf
// for a slot past T.
__device__ __forceinline__ float key_bias(int key, int seq, uint8_t masked) {
  return key >= seq ? -INFINITY : (masked ? -FLT_MAX : 0.f);
}

// Where element (b, h, t, i) of a per-head tensor lies: p[b·batch + h·head
// + t·row + i]. The attention kernels read and write q, k, v, o and their
// gradients through it, so one kernel serves two layouts:
//   * (B, H, T, d) contiguous, the flash-attention path's;
//   * token-major (B·T, ld) with head h at columns h·d, the fused block's
//     (q, k, v as column blocks of one (B·T, 3D) matrix, o as (B·T, D)),
//     which is what its products read and write.
struct HeadStrides {
  long long batch, head;
  int row;
  __host__ __device__ __forceinline__ size_t at(int b, int h) const {
    return (size_t)(b * batch + h * head);
  }
};

inline HeadStrides contiguous_heads(int H, int seq, int d) {
  return {(long long)H * seq * d, (long long)seq * d, d};
}
inline HeadStrides token_major(int seq, int ld, int d) { return {(long long)seq * ld, d, ld}; }

}  // namespace wavjepa
