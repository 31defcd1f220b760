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
