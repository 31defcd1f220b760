// The masked self-attention backward (flash_attention_bwd.cuh, which says
// what it computes, what bounds it and how) as a library with a plain C
// entry point, for ops/flash_attention.py.

#include "flash_attention_bwd.cuh"

extern "C" int wavjepa_flash_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* mask, const void* dout, const void* stats,
                                           void* dsum, void* dq, void* dk, void* dv, int B, int H,
                                           int seq, int head_dim, int dtype, float scale,
                                           void* stream) {
  const wavjepa::HeadStrides heads = wavjepa::contiguous_heads(H, seq, head_dim);
  return wavjepa::flash_attention_bwd(q, k, v, static_cast<const uint8_t*>(mask), dout,
                                      static_cast<const float*>(stats), static_cast<float*>(dsum),
                                      dq, dk, dv, B, H, seq, head_dim, dtype, scale, heads, heads,
                                      static_cast<cudaStream_t>(stream));
}

// The kernel that wavjepa_flash_attention_bwd (and the fused block's
// backward) runs at this T, head_dim and dtype: 0 f32 on CUDA cores, 1 bf16
// in one pass (T ≤ 128), 2 bf16 in two passes, -1 none (the call would
// return cudaErrorInvalidValue).
extern "C" int wavjepa_flash_attention_bwd_route(int seq, int head_dim, int dtype) {
  return wavjepa::flash_bwd_route(seq, head_dim, dtype);
}
