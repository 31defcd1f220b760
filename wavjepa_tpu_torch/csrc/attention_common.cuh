// Helpers shared by the attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): the bf16 mma.sync product of the two-pass
// backward, fragment packing, the reductions over the lanes that share a
// row, 2^x, a key's sentinel, and the per-head strides.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace wavjepa {

// C (16×8, f32) += A (16×16, bf16, row-major) · B (16×8, bf16, column-major).
// Fragment layout of mma m16n8k16 (PTX ISA), lane = 4·g + c:
//   A (16×16): a0 (row g, cols 2c, 2c+1), a1 (row g+8, same), a2/a3 (cols +8)
//   B (16×8):  b0 (k = 2c, 2c+1, n = g), b1 (k + 8)
//   C (16×8):  c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8)
__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The A fragments of 16 rows (row0 and row0 + 8 for this lane) of a
// row-major bf16 matrix with rows ld apart, all of D; rows past the end read
// as zero.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const __nv_bfloat16* base,
                                            int ld, int row0, bool in0, bool in1, int c) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* p0 = base + (size_t)row0 * ld + ks * 16 + 2 * c;
    const __nv_bfloat16* p1 = p0 + 8 * (size_t)ld;
    a[ks][0] = in0 ? load_u32(p0) : 0u;
    a[ks][1] = in1 ? load_u32(p1) : 0u;
    a[ks][2] = in0 ? load_u32(p0 + 8) : 0u;
    a[ks][3] = in1 ? load_u32(p1 + 8) : 0u;
  }
}

}  // namespace wavjepa
