// Projection-fused attention block forward for Hopper (sm_90a):
// OutProj(MHSA(QKVProj(x))) with a key-padding mask.
//
// Replaces the TPU kernel wavjepa_tpu/ops/fused_attention_block.py:_fwd_kernel
// (launched by _fwd through pl.pallas_call). Per batch row, with x (T, D),
// Wqkv (H, D, 3·hd), bqkv (H, 1, 3·hd), Wo (H, hd, D), bo (1, D):
//     qkv_h = (x·Wqkv[h] summed in f32 + bqkv[h]) rounded to x's type
//     P     = softmax(d^-1/2 · q_h k_hᵀ in f32, masked keys very negative), f32
//     o_h   = (P rounded) · v_h summed in f32, rounded
//     out   = (Σ_h o_h·Wo[h] + bo) in f32, rounded once
// in bf16 (training and serving) or f32 (parity checks), head_dim 32 or 64.
// The heads may be a subset of D's: under tensor parallelism a rank holds
// H of them, an attention width A = H·hd below the model width D, and its
// Wqkv is (D × 3A), Wo (A × D); bo may be left out (the caller adds it after
// the ranks' partial outputs are summed). At A = D the block is whole.
// A masked key gets the finite f32 minimum where the TPU kernel uses
// −0.7·f32max: both give exp() = 0 beside any real key and uniform weights
// on a fully masked row, so the results are the same.
//
// What bounds it on an H100. The work is 8·B·T·D·A operations for the
// projections (6 for QKV, 2 for the output) and 4·B·T²·A for attention; the
// bytes are x read and out written once, the weights once and the mask:
// 2·B·T·D·e + 4·D·A·e + B·T. That is at least 4·A/e operations a byte (768
// at A = D = 384 in bf16, 384 at a tensor-parallel rank's A = 192), above
// the ~295 at which the tensor cores become the limit, so it is bound by
// operations: about 11 µs at the decoder
// microbatch (64, 128, 384) and 43 µs at the windowed serving batch
// (40, 200, 768) at 989 TFLOP/s.
//
// What the design does about that. The TPU kernel keeps one batch row in
// VMEM: x and its f32 accumulator (T × D) and the T × T scores. A Hopper
// block has 227 KB: one head's K and V at T = 999, hd = 64 are 256 KB, and a
// 64-row f32 output accumulator at D = 768 is 196 KB, so neither the row nor
// the sum over heads fits a block. Three launches on the caller's stream,
// each on the tensor cores in bf16:
//   1. the QKV projection, a product (B·T × D)·(D × 3A) with the bias added
//      and rounded in its epilogue, written token-major as (B·T, 3A) —
//      q, k, v are its three column blocks (hopper_gemm.cuh: TMA, wgmma);
//   2. attention per (batch, head, 128 query rows) with an online softmax
//      over 128-key tiles, reading each head's q, k, v through rank-4 TMA
//      maps with a row stride of 3A and writing o rounded to x's type as
//      (B·T, A) (flash_attention_fwd.cuh, the same core as the unfused path);
//   3. the output projection, (B·T × A)·(A × D) over o's columns, which are
//      (head, i): the sum over heads is one f32 sum rounded once, plus bo.
// Every operand of both products is then a plain row-major matrix, so one
// 2-D TMA descriptor loads each tile; nothing is permuted in device memory.
// q, k, v and o make one round trip through device memory (8·B·T·D·e bytes
// more than the bound counts, 50 MB at the decoder microbatch, largely
// within the 50 MB L2 at the smaller shapes); nothing of size T² does. The
// caller passes that scratch: the kernels allocate nothing. f32 (parity
// checks) runs the same three steps with block_gemm.cuh's FMA products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_attention_fwd.cuh"
#include "hopper_gemm.cuh"

namespace {

namespace bg = wavjepa::block_gemm;
namespace hg = wavjepa::hopper_gemm;
using wavjepa::flash_attention_fwd;
using wavjepa::token_major;

template <typename T>
cudaError_t forward(const T* x, const T* w_in, const T* b_in, const T* w_out, const T* b_out,
                    const uint8_t* mask, T* out, T* scratch, int B, int seq, int H, int hd, int D,
                    int dtype, float scale, cudaStream_t s) {
  const int A = H * hd, M = B * seq;
  T* qkv = scratch;                      // (B·T, 3A): q | k | v, each (head, i)
  T* o = scratch + (size_t)3 * M * A;    // (B·T, A)
  // 1. qkv[m, j] = x[m, :] · w_in[j, :] + b_in[j]
  cudaError_t err;
  if constexpr (sizeof(T) == 2)
    err = hg::gemm<0, 0>(x, D, w_in, D, hg::ToBf16{qkv, 3 * A, b_in}, M, 3 * A, D, 1, s);
  else
    err = bg::gemm(bg::Along{{x, D}, M}, bg::Along{{w_in, D}, 3 * A}, bg::ToRows{qkv, 3 * A, b_in},
                   M, 3 * A, D, 1, s);
  if (err != cudaSuccess) return err;
  // 2. o = attention of each (batch, head)
  err = flash_attention_fwd(qkv, qkv + A, qkv + 2 * A, mask, o, nullptr, B, H, seq, hd, dtype,
                            scale, token_major(seq, 3 * A, hd), token_major(seq, A, hd), s);
  if (err != cudaSuccess) return err;
  // 3. out[m, n] = o[m, :] · w_out[n, :] (+ b_out[n])
  if constexpr (sizeof(T) == 2)
    return hg::gemm<0, 0>(o, A, w_out, A, hg::ToBf16{out, D, b_out}, M, D, A, 1, s);
  else
    return bg::gemm(bg::Along{{o, A}, M}, bg::Along{{w_out, A}, D}, bg::ToRows{out, D, b_out}, M,
                    D, A, 1, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64; H heads of it make
// the attention width A = H·head_dim ≤ D, the model width (a multiple of 8).
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for a shape or
// type it does not take. All contiguous and 16-byte aligned, in the torch
// module's layouts: x, out (B, T, D); w_in (3A, D), rows (part, head, i),
// MultiheadAttention's in_proj_weight; b_in (3A,) in the same order; w_out
// (D, A), out_proj.weight, columns (head, i); b_out (D,) or null for none;
// mask (B, T) bytes; scratch 4·B·T·A elements of x's type.
extern "C" int wavjepa_fused_attention_block_fwd(const void* x, const void* w_in,
                                                 const void* b_in, const void* w_out,
                                                 const void* b_out, const void* mask, void* out,
                                                 void* scratch, int B, int seq, int H,
                                                 int head_dim, int D, int dtype, float scale,
                                                 void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || B > 65535 || (head_dim != 32 && head_dim != 64) ||
      D <= 0 || D % 8 || H * head_dim > D)
    return cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(static_cast<const float*>(x), static_cast<const float*>(w_in),
                          static_cast<const float*>(b_in), static_cast<const float*>(w_out),
                          static_cast<const float*>(b_out), m, static_cast<float*>(out),
                          static_cast<float*>(scratch), B, seq, H, head_dim, D, dtype, scale, s);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return forward<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w_in),
                       static_cast<const bf*>(b_in), static_cast<const bf*>(w_out),
                       static_cast<const bf*>(b_out), m, static_cast<bf*>(out),
                       static_cast<bf*>(scratch), B, seq, H, head_dim, D, dtype, scale, s);
  }
  return cudaErrorInvalidValue;
}
