// The masked self-attention forward (flash_attention_fwd.cuh, which says
// what it computes, what bounds it and how) as a library with a plain C
// entry point, for ops/flash_attention.py.

#include "flash_attention_fwd.cuh"

extern "C" int wavjepa_flash_attention_fwd(const void* q, const void* k, const void* v,
                                           const void* mask, void* o, void* stats, int B, int H,
                                           int seq, int head_dim, int dtype, float scale,
                                           void* stream) {
  const wavjepa::HeadStrides heads = wavjepa::contiguous_heads(H, seq, head_dim);
  return wavjepa::flash_attention_fwd(q, k, v, static_cast<const uint8_t*>(mask), o,
                                      static_cast<float*>(stats), B, H, seq, head_dim, dtype,
                                      scale, heads, heads, static_cast<cudaStream_t>(stream));
}
