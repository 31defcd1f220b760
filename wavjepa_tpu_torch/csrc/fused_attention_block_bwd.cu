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
// stream, every product on the tensor cores in bf16 (hopper_gemm.cuh: TMA
// loads into a ring of stages, wgmma, persistent blocks), nothing of size T²
// in device memory and no atomics (two calls give equal bits). Activations
// are token-major, so each product reads plain row-major matrices, K-major
// or MN-major as it needs them:
//   1. the QKV projection again, qkv (B·T, 3D);
//   2. attention forward with each row's (max, sum), o (B·T, D)
//      (flash_attention_fwd.cuh, reading the heads with a row stride);
//   3. dO = g·Wo, rounded, (B·T, D) (Wo read MN-major);
//   4. dq, dk, dv by flash_attention_bwd.cuh (one block per (batch, head) at
//      T ≤ 128, two deterministic passes above), rounded, into the column
//      blocks of dqkv (B·T, 3D);
//   5. dx = dqkv·W_in (W_in read MN-major): one f32 sum, rounded once;
//   6. dW_in = dqkvᵀ·x and dWo = gᵀ·o, both operands MN-major, each over a
//      fixed number of row chunks (at most 16, chosen by the caller from the
//      tile count, never from B), one f32 partial per chunk;
//   7. the bias gradients Σ_rows dqkv and Σ_rows g, per row chunk into the
//      same partials (block_gemm.cuh's column sums);
//   8. the partials summed in chunk order.
// The scratch (q, k, v, o, dO, dq, dk, dv: 8·B·T·D·e; row statistics; the
// f32 partials, at most 16·(3D² + D² + 4D) floats) is the caller's. f32
// (parity checks) runs the same chain with block_gemm.cuh's FMA products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_attention_bwd.cuh"
#include "flash_attention_fwd.cuh"
#include "hopper_gemm.cuh"

namespace {

namespace bg = wavjepa::block_gemm;
namespace hg = wavjepa::hopper_gemm;
using wavjepa::flash_attention_bwd;
using wavjepa::flash_attention_fwd;
using wavjepa::token_major;

struct Buffers {
  const uint8_t* mask;
  float *grad_in, *grad_out;  // (3D·D + 3D), (D·D + D) f32
  void* acts;                 // 8·B·T·D of x's type
  float *stats, *dsum, *part_in, *part_out;
};

template <typename T>
cudaError_t backward(const T* x, const T* w_in, const T* b_in, const T* w_out, const T* g, T* dx,
                     const Buffers& buf, int B, int seq, int H, int hd, int dtype, int splits_in,
                     int splits_out, float scale, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int D = H * hd, M = B * seq;
  const size_t md = (size_t)M * D;
  T* qkv = static_cast<T*>(buf.acts);  // (B·T, 3D)
  T* o = qkv + 3 * md;                 // (B·T, D)
  T* dout = o + md;                    // (B·T, D)
  T* dqkv = dout + md;                 // (B·T, 3D)
  const size_t n_in = (size_t)3 * D * D + 3 * D, n_out = (size_t)D * D + D;
  const wavjepa::HeadStrides heads3 = token_major(seq, 3 * D, hd), heads1 = token_major(seq, D, hd);
  cudaError_t err;
#define RETURN_ON_ERROR(...)                               \
  do {                                                     \
    if ((err = (__VA_ARGS__)) != cudaSuccess) return err; \
  } while (0)
  // 1. qkv[m, j] = x[m, :] · w_in[j, :] + b_in[j]
  if constexpr (kBf16)
    RETURN_ON_ERROR(hg::gemm<0, 0>(x, D, w_in, D, hg::ToBf16{qkv, 3 * D, b_in}, M, 3 * D, D, 1, s));
  else
    RETURN_ON_ERROR(bg::gemm(bg::Along{{x, D}, M}, bg::Along{{w_in, D}, 3 * D},
                             bg::ToRows{qkv, 3 * D, b_in}, M, 3 * D, D, 1, s));
  // 2. o and each row's (max, sum)
  RETURN_ON_ERROR(flash_attention_fwd(qkv, qkv + D, qkv + 2 * D, buf.mask, o, buf.stats, B, H, seq,
                                      hd, dtype, scale, heads3, heads1, s));
  // 3. dout[m, c] = g[m, :] · w_out[:, c]
  if constexpr (kBf16)
    RETURN_ON_ERROR(hg::gemm<0, 1>(g, D, w_out, D, hg::ToBf16{dout, D, nullptr}, M, D, D, 1, s));
  else
    RETURN_ON_ERROR(bg::gemm(bg::Along{{g, D}, M}, bg::Across{{w_out, D}, D},
                             bg::ToRows{dout, D, nullptr}, M, D, D, 1, s));
  // 4. dq, dk, dv into dqkv's column blocks
  RETURN_ON_ERROR(flash_attention_bwd(qkv, qkv + D, qkv + 2 * D, buf.mask, dout, buf.stats,
                                      buf.dsum, dqkv, dqkv + D, dqkv + 2 * D, B, H, seq, hd,
                                      dtype, scale, heads3, heads1, s));
  // 5. dx[m, d] = dqkv[m, :] · w_in[:, d]
  if constexpr (kBf16)
    RETURN_ON_ERROR(hg::gemm<0, 1>(dqkv, 3 * D, w_in, D, hg::ToBf16{dx, D, nullptr}, M, D, 3 * D,
                                   1, s));
  else
    RETURN_ON_ERROR(bg::gemm(bg::Along{{dqkv, 3 * D}, M}, bg::Across{{w_in, D}, D},
                             bg::ToRows{dx, D, nullptr}, M, D, 3 * D, 1, s));
  // 6. dW_in[j, d] = Σ_m dqkv[m, j] · x[m, d]; dWo[n, c] = Σ_m g[m, n] · o[m, c]
  if constexpr (kBf16) {
    RETURN_ON_ERROR(hg::gemm<1, 1, false>(dqkv, 3 * D, x, D, hg::ToPartial{buf.part_in, D, n_in},
                                          3 * D, D, M, splits_in, s));
    RETURN_ON_ERROR(hg::gemm<1, 1, false>(g, D, o, D, hg::ToPartial{buf.part_out, D, n_out}, D, D,
                                          M, splits_out, s));
  } else {
    RETURN_ON_ERROR(bg::gemm(bg::Across{{dqkv, 3 * D}, 3 * D}, bg::Across{{x, D}, D},
                             bg::ToPartial{buf.part_in, D, n_in}, 3 * D, D, M, splits_in, s));
    RETURN_ON_ERROR(bg::gemm(bg::Across{{g, D}, D}, bg::Across{{o, D}, D},
                             bg::ToPartial{buf.part_out, D, n_out}, D, D, M, splits_out, s));
  }
  // 7. db_in = Σ_m dqkv[m, :], dbo = Σ_m g[m, :], per row chunk
  RETURN_ON_ERROR(bg::sum_columns(dqkv, M, 3 * D, splits_in, buf.part_in + (size_t)3 * D * D,
                                  n_in, s));
  RETURN_ON_ERROR(bg::sum_columns(g, M, D, splits_out, buf.part_out + (size_t)D * D, n_out, s));
  // 8. the partials in chunk order
  RETURN_ON_ERROR(bg::reduce_partials(buf.part_in, buf.grad_in, splits_in, n_in, s));
  return bg::reduce_partials(buf.part_out, buf.grad_out, splits_out, n_out, s);
#undef RETURN_ON_ERROR
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t
// (0 = launched); cudaErrorInvalidValue for a shape or type it does not take.
// All contiguous and 16-byte aligned: x, g, dx (B, T, D); w_in (3D, D), b_in
// (3D,), w_out (D, D) as for wavjepa_fused_attention_block_fwd; mask (B, T)
// bytes. Out: dx; grad_in (3D·D + 3D) f32, dW_in (3D, D) in in_proj_weight's
// layout, then its bias (3D,); grad_out (D·D + D) f32, dWo (D, D) in
// out_proj.weight's layout, then dbo. Scratch: acts 8·B·T·D of x's type;
// stats (B, H, T, 2) and dsum (B, H, T) f32; part_in (splits_in, 3D·D + 3D)
// and part_out (splits_out, D·D + D) f32.
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
