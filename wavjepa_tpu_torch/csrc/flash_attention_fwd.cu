// The masked self-attention forward (flash_attention_fwd.cuh, which says
// what it computes, what bounds it and how) and its gated relative-position
// bias variant, as a library with plain C entry points, for
// ops/flash_attention.py.

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

// The gated relative-position bias variant (relbias_flash in the header).
extern "C" int wavjepa_relbias_flash_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* table, const void* gate,
                                         void* o, int B, int H, int seq, int head_dim, int dtype,
                                         float scale, void* stream) {
  return wavjepa::relbias_flash_attention_fwd(
      q, k, v, static_cast<const uint8_t*>(mask), static_cast<const float*>(table),
      static_cast<const float*>(gate), o, B, H, seq, head_dim, dtype, scale,
      static_cast<cudaStream_t>(stream));
}
