// Projection-fused attention block backward for Hopper (sm_90a): dx and the
// weight gradients of fused_attention_block_fwd.cu, the forward recomputed
// from its inputs.
//
// Replaces the TPU kernel wavjepa_tpu/ops/fused_attention_block.py:_bwd_kernel
// (launched by _bwd through pl.pallas_call). With g the upstream gradient in
// x's type and "rounded" meaning rounded to x's type:
//     dbo    = Σ_rows g                                         f32
//     per head h, from the recomputed qkv_h, P (f32) and o_h:
//     dWo[h] = o_hᵀ·g;  do_h = g·Wo[h]ᵀ rounded
//     dv = P_loᵀ·do_h;  dp = do_h·v_hᵀ;  dS = P ⊙ (dp − rowsum(dp ⊙ P)), f32,
//          with no zeroing at masked keys (a fully masked row keeps its dS)
//     dq = d^-1/2 · dS_lo·k_h;  dk = d^-1/2 · dS_loᵀ·q_h
//     dqkv_h = [dq | dk | dv] rounded, then dbqkv[h] = Σ_rows dqkv_h,
//     dWqkv[h] = xᵀ·dqkv_h, dx = Σ_h dqkv_h·Wqkv[h]ᵀ in f32, rounded once
// with every weight gradient an f32 sum over all B·T rows.
//
// What bounds it on an H100. 22·B·T·D² operations for the products
// (recomputed QKV 6, dO 2, dx 6, dWqkv 6, dWo 2) and 12·B·T²·D for the
// attention core (the recomputed Q·Kᵀ and P·V, then dP, dV, dQ, dK); bytes
// 3·B·T·D·e (x and g read, dx written) + 4·D²·(e + 4) (the weights read,
// their f32 gradients written) + the mask. Bound by operations: about 32 µs
// at the decoder microbatch (64, 128, 384) and 20 µs at the encoder
// microbatch (16, 88, 768) at 989 TFLOP/s.
//
// What the design does about that. The TPU kernel sums the weight
// gradients across a sequential grid in output blocks that persist; Hopper
// blocks run in no order. So this is a chain of launches on the caller's
// stream, every product on the tensor cores in bf16, nothing of size T² in
// device memory and no atomics (two calls give equal bits):
//   1. the QKV projection again, split by head (block_gemm.cuh);
//   2. attention forward with each row's (max, sum), o as (B, H, T, hd)
//      (flash_attention_fwd.cuh);
//   3. dO = g·Wo_flatᵀ, rounded, split by head;
//   4. dq, dk, dv by the two deterministic passes of flash_attention_bwd.cuh,
//      rounded, as (3, B, H, T, hd): that is dqkv;
//   5. dx = dqkv·Wqkv_flat, read across heads: one f32 sum, rounded once;
//   6. dWqkv = xᵀ·dqkv and dWo = oᵀ·g, each over a fixed number of row
//      chunks (at most 16, chosen by the caller from the tile count, never
//      from B), one f32 partial per chunk; the blocks of the first row tile
//      also sum the columns of dqkv and g, the bias gradients;
//   7. the partials summed in chunk order.
// The scratch (q, k, v, o, dO, dq, dk, dv: 8·B·T·D·e; row statistics; the
// f32 partials, at most 16·(3D² + D² + 4D) floats) is the caller's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_attention_bwd.cuh"
#include "flash_attention_fwd.cuh"

namespace {

using namespace wavjepa::block_gemm;
using wavjepa::flash_attention_bwd;
using wavjepa::flash_attention_fwd;

struct Buffers {
  const uint8_t* mask;
  float *grad_in, *grad_out;  // (D·3D + 3D), (D·D + D) f32
  void* acts;                 // 8·B·T·D of x's type
  float *stats, *dsum, *part_in, *part_out;
};

template <typename T>
cudaError_t backward(const T* x, const T* w_in, const T* b_in, const T* w_out, const T* g, T* dx,
                     const Buffers& buf, int B, int seq, int H, int hd, int dtype, int splits_in,
                     int splits_out, float scale, cudaStream_t s) {
  const int D = H * hd, M = B * seq;
  const size_t md = (size_t)M * D;
  T* qkv = static_cast<T*>(buf.acts);  // (3, B, H, T, hd)
  T* o = qkv + 3 * md;                 // (B, H, T, hd)
  T* dout = o + md;                    // (B, H, T, hd)
  T* dqkv = dout + md;                 // (3, B, H, T, hd)
  const size_t n_in = (size_t)3 * D * D + 3 * D, n_out = (size_t)D * D + D;
  cudaError_t err;
#define RETURN_ON_ERROR(call)       \
  if ((err = (call)) != cudaSuccess) \
  return err
  // 1. qkv[m, (p, h, i)] = x[m, :] · w_in[(p, h, i), :] + b_in
  RETURN_ON_ERROR(gemm<T>(Along<T, RowMajor<const T>>{{x, D}, M},
                          Along<T, RowMajor<const T>>{{w_in, D}, 3 * D},
                          ToHeads<T>{{qkv, B, H, seq, hd}, b_in}, M, 3 * D, D, 1, nullptr, 0, s));
  // 2. o and each row's (max, sum)
  RETURN_ON_ERROR(flash_attention_fwd(qkv, qkv + md, qkv + 2 * md, buf.mask, o, buf.stats, B, H,
                                      seq, hd, dtype, scale, s));
  // 3. dout[m, (h, i)] = g[m, :] · w_out[(h, i), :]
  RETURN_ON_ERROR(gemm<T>(Along<T, RowMajor<const T>>{{g, D}, M},
                          Along<T, RowMajor<const T>>{{w_out, D}, D},
                          ToHeads<T>{{dout, B, H, seq, hd}, nullptr}, M, D, D, 1, nullptr, 0, s));
  // 4. dq, dk, dv
  RETURN_ON_ERROR(flash_attention_bwd(qkv, qkv + md, qkv + 2 * md, buf.mask, dout, buf.stats,
                                      buf.dsum, dqkv, dqkv + md, dqkv + 2 * md, B, H, seq, hd,
                                      dtype, scale, s));
  // 5. dx[m, d] = dqkv[m, (p, h, i)] · w_in[(p, h, i), d]
  RETURN_ON_ERROR(gemm<T>(Along<T, Heads<const T>>{{dqkv, B, H, seq, hd}, M},
                          Across<T, RowMajor<const T>>{{w_in, D}, D}, ToRows<T>{dx, D, nullptr}, M,
                          D, 3 * D, 1, nullptr, 0, s));
  // 6. dW_in[d, (p, h, i)] = Σ_m x[m, d] · dqkv[m, (p, h, i)], db_in = Σ_m dqkv;
  //    dWo[(h, i), n] = Σ_m o[m, (h, i)] · g[m, n], dbo = Σ_m g
  RETURN_ON_ERROR(gemm<T>(Across<T, RowMajor<const T>>{{x, D}, D},
                          Across<T, Heads<const T>>{{dqkv, B, H, seq, hd}, 3 * D},
                          ToPartial{buf.part_in, 3 * D, n_in}, D, 3 * D, M, splits_in,
                          buf.part_in + (size_t)3 * D * D, n_in, s));
  RETURN_ON_ERROR(gemm<T>(Across<T, Heads<const T>>{{o, B, H, seq, hd}, D},
                          Across<T, RowMajor<const T>>{{g, D}, D}, ToPartial{buf.part_out, D, n_out},
                          D, D, M, splits_out, buf.part_out + (size_t)D * D, n_out, s));
  // 7. the partials in chunk order
  RETURN_ON_ERROR(reduce_partials(buf.part_in, buf.grad_in, splits_in, n_in, s));
  return reduce_partials(buf.part_out, buf.grad_out, splits_out, n_out, s);
#undef RETURN_ON_ERROR
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t
// (0 = launched); cudaErrorInvalidValue for a shape or type it does not take.
// All contiguous: x, g, dx (B, T, D); w_in (3D, D), b_in (3D,), w_out (D, D)
// as for wavjepa_fused_attention_block_fwd; mask (B, T) bytes. Out: dx;
// grad_in (D·3D + 3D) f32, dW_in (D, 3D) with columns (part, head, i) then its
// bias (3D,); grad_out (D·D + D) f32, dWo (D, D) with rows (head, i) then dbo.
// Scratch: acts 8·B·T·D of x's type; stats (B, H, T, 2) and dsum (B, H, T)
// f32; part_in (splits_in, D·3D + 3D) and part_out (splits_out, D·D + D) f32.
extern "C" int wavjepa_fused_attention_block_bwd(
    const void* x, const void* w_in, const void* b_in, const void* w_out, const void* mask,
    const void* g, void* dx, void* grad_in, void* grad_out, void* acts, void* stats, void* dsum,
    void* part_in, void* part_out, int B, int seq, int H, int head_dim, int dtype, int splits_in,
    int splits_out, float scale, void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || B > 65535 || (head_dim != 32 && head_dim != 64) ||
      splits_in <= 0 || splits_out <= 0)
    return cudaErrorInvalidValue;
  const Buffers buf{static_cast<const uint8_t*>(mask), static_cast<float*>(grad_in),
                    static_cast<float*>(grad_out),     acts,
                    static_cast<float*>(stats),        static_cast<float*>(dsum),
                    static_cast<float*>(part_in),      static_cast<float*>(part_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(static_cast<const float*>(x), static_cast<const float*>(w_in),
                           static_cast<const float*>(b_in), static_cast<const float*>(w_out),
                           static_cast<const float*>(g), static_cast<float*>(dx), buf, B, seq, H,
                           head_dim, dtype, splits_in, splits_out, scale, s);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return backward<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w_in),
                        static_cast<const bf*>(b_in), static_cast<const bf*>(w_out),
                        static_cast<const bf*>(g), static_cast<bf*>(dx), buf, B, seq, H, head_dim,
                        dtype, splits_in, splits_out, scale, s);
  }
  return cudaErrorInvalidValue;
}
