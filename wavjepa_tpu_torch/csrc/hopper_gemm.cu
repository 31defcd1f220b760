// The fused block's bf16 product (hopper_gemm.cuh, which says what bounds it
// and how it is built) alone, with a plain C entry point, so that
// chip_smoke.py can hold it against torch.matmul at the block's shapes. No
// module of the package calls it: the fused kernels compile the header.

#include "block_gemm.cuh"
#include "hopper_gemm.cuh"

// weight_grad = 0: a (M, K) and b (N, K) row-major bf16, c (M, N) bf16 =
// a·bᵀ (the QKV projection's product). weight_grad = 1: a (K, M) and b (K, N)
// row-major bf16, c (M, N) f32 = aᵀ·b, as the weight gradients sum over the
// tokens: `splits` f32 partials in `partials` (splits·M·N floats), then
// summed in chunk order. Returns a cudaError_t (0 = launched).
extern "C" int wavjepa_hopper_gemm(const void* a, const void* b, void* c, void* partials, int M,
                                   int N, int K, int weight_grad, int splits, void* stream) {
  namespace hg = wavjepa::hopper_gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight_grad == 0)
    return hg::gemm<0, 0>(a, K, b, K, hg::ToBf16{static_cast<__nv_bfloat16*>(c), N, nullptr}, M,
                          N, K, 1, s);
  if (splits <= 0) return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  const size_t n = (size_t)M * N;
  cudaError_t err = hg::gemm<1, 1, false>(a, M, b, N, hg::ToPartial{part, N, n}, M, N, K, splits, s);
  if (err != cudaSuccess) return err;
  return wavjepa::block_gemm::reduce_partials(part, static_cast<float*>(c), splits, n, s);
}
