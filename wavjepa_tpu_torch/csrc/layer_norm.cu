// LayerNorm over the last dimension in float32, with the residual add in
// front of it fused in, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this norm to XLA, which
// fuses the add, the statistics and the affine into one pass on the TPU. In
// eager PyTorch the same maths (ops/layer_norm.py: layer_norm32_reference)
// is about a dozen elementwise and reduction kernels forward and two dozen
// backward, each with a full f32 intermediate in device memory, ahead of
// every norm of every transformer stack. Per row of D values:
//     s    = x + residual, rounded to x's type (bf16 or f32), or s = x
//     mean = Σ s / D,  var = Σ (s − mean)² / D (centred, biased), in f32
//     rstd = 1 / sqrt(var + eps)
//     y    = ((s − mean)·rstd)·w + b in f32, each product and sum rounded
//            as the plain version rounds it, then once to the output type
// and backward, with x̂ = (s − mean)·rstd and g = dy·w,
//     ds   = rstd·(g − mean(g) − x̂·mean(g·x̂)), rounded once to s's type
//            (the gradient of x and of the residual both)
//     dw   = Σ_rows dy·x̂,  db = Σ_rows dy, in f32.
//
// What bounds it on an H100. Under one operation a byte: memory. The
// forward reads x (and the residual) and writes y, plus s and two f32
// statistics a row when a gradient will be taken; the backward reads dy and
// s and writes ds. At bf16 with a residual that is 6 bytes an element
// (serving, the teacher) or 8 (training) forward and 6 backward: about
// 55 µs forward and 41 µs backward for the student encoder's (22528, 768)
// at 3.35 TB/s.
//
// What the design does about that. One warp holds one row in registers (at
// most 32 values a lane at D = 1024), read once in 16-byte vectors with
// neighbouring lanes on neighbouring addresses; the two statistics are two
// butterfly sums over the warp's lanes (every lane ends with the same bits),
// so nothing but the inputs and outputs crosses device memory, and each
// byte crosses it once. Widths 384, 512, 768 and 1024 get their own
// instantiation, with the vector width that divides the row evenly over 32
// lanes; any other width up to 1024 takes a general instantiation with
// scalar accesses. The backward's warps walk a fixed set of rows each
// (grid-stride over a grid the caller fixes), keep their lanes' dw and db
// sums in registers, and add them warp by warp, in order, into one partial
// row a block; a second small kernel sums the blocks' partials column by
// column in a fixed order. No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wavjepa::layer_norm {

constexpr int kWarps = 8;      // rows in flight a block, one warp each
constexpr int kMaxD = 1024;    // widest row: 32 values a lane
constexpr int kReduceCols = 32, kReduceGroups = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC neighbouring elements, moved in one aligned access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// The widest vector (at most 16 bytes of T) that splits a row of D values
// evenly over 32 lanes; 1 for the general instantiation (D = 0).
template <typename T>
constexpr int vec_for(int D) {
  if (D == 0) return 1;
  int v = 16 / static_cast<int>(sizeof(T));
  while (v > 1 && D % (32 * v) != 0) v /= 2;
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Chunk j of a lane is elements [(j·32 + lane)·VEC, … + VEC) of its row.
template <typename TIn, int DS>
struct Shape {
  static constexpr int VEC = vec_for<TIn>(DS);
  static constexpr int NC = DS ? DS / (32 * VEC) : kMaxD / 32;
};

template <typename TIn, typename TOut, int DS>
__global__ void __launch_bounds__(kWarps * 32)
    forward_kernel(const TIn* __restrict__ x, const TIn* __restrict__ res,
                   const float* __restrict__ w, const float* __restrict__ b, TOut* __restrict__ y,
                   TIn* __restrict__ s_out, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, int rows, int d_runtime, float eps) {
  constexpr int VEC = Shape<TIn, DS>::VEC, NC = Shape<TIn, DS>::NC;
  const int D = DS ? DS : d_runtime;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;

  float v[NC][VEC];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e = (j * 32 + lane) * VEC;
    if (e < D) {
      Vec<TIn, VEC> a = *reinterpret_cast<const Vec<TIn, VEC>*>(x + base + e);
      if (res != nullptr) {
        const Vec<TIn, VEC> r = *reinterpret_cast<const Vec<TIn, VEC>*>(res + base + e);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          a.v[k] = from_f32<TIn>(__fadd_rn(to_f32(a.v[k]), to_f32(r.v[k])));
        if (s_out != nullptr) *reinterpret_cast<Vec<TIn, VEC>*>(s_out + base + e) = a;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[j][k] = to_f32(a.v[k]);
        sum += v[j][k];
      }
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(D));
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if ((j * 32 + lane) * VEC < D) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float c = __fsub_rn(v[j][k], mean);
        sq = __fmaf_rn(c, c, sq);
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(D));
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e = (j * 32 + lane) * VEC;
    if (e < D) {
      const Vec<float, VEC> wv = *reinterpret_cast<const Vec<float, VEC>*>(w + e);
      const Vec<float, VEC> bv = *reinterpret_cast<const Vec<float, VEC>*>(b + e);
      Vec<TOut, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = __fmul_rn(__fsub_rn(v[j][k], mean), rstd);
        o.v[k] = from_f32<TOut>(__fadd_rn(__fmul_rn(xhat, wv.v[k]), bv.v[k]));
      }
      *reinterpret_cast<Vec<TOut, VEC>*>(y + base + e) = o;
    }
  }
  if (lane == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// One pass over the rows: ds for each, and the block's partial dw and db
// (its warps' sums added in warp order) into row blockIdx.x of the partials.
template <typename TIn, typename TOut, int DS>
__global__ void __launch_bounds__(kWarps * 32)
    backward_kernel(const TOut* __restrict__ dy, const TIn* __restrict__ s,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ w, TIn* __restrict__ ds,
                    float* __restrict__ dw_part, float* __restrict__ db_part, int rows,
                    int d_runtime) {
  constexpr int VEC = Shape<TIn, DS>::VEC, NC = Shape<TIn, DS>::NC;
  const int D = DS ? DS : d_runtime;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float sdw[kMaxD], sdb[kMaxD];

  float dwa[NC][VEC], dba[NC][VEC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) dwa[j][k] = dba[j][k] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * D;
    const float m = mean[row], r = rstd[row];
    float xh[NC][VEC], g[NC][VEC];
    float sum_g = 0.f, sum_gx = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (j * 32 + lane) * VEC;
      if (e < D) {
        const Vec<TOut, VEC> dv = *reinterpret_cast<const Vec<TOut, VEC>*>(dy + base + e);
        const Vec<TIn, VEC> sv = *reinterpret_cast<const Vec<TIn, VEC>*>(s + base + e);
        const Vec<float, VEC> wv = *reinterpret_cast<const Vec<float, VEC>*>(w + e);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float d = to_f32(dv.v[k]);
          xh[j][k] = (to_f32(sv.v[k]) - m) * r;
          g[j][k] = d * wv.v[k];
          sum_g += g[j][k];
          sum_gx = fmaf(g[j][k], xh[j][k], sum_gx);
          dwa[j][k] = fmaf(d, xh[j][k], dwa[j][k]);
          dba[j][k] += d;
        }
      }
    }
    const float mg = warp_sum(sum_g) / D, mgx = warp_sum(sum_gx) / D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (j * 32 + lane) * VEC;
      if (e < D) {
        Vec<TIn, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          o.v[k] = from_f32<TIn>(r * (g[j][k] - mg - xh[j][k] * mgx));
        *reinterpret_cast<Vec<TIn, VEC>*>(ds + base + e) = o;
      }
    }
  }

  for (int turn = 0; turn < kWarps; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int e = (j * 32 + lane) * VEC;
        if (e < D) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            sdw[e + k] = turn == 0 ? dwa[j][k] : sdw[e + k] + dwa[j][k];
            sdb[e + k] = turn == 0 ? dba[j][k] : sdb[e + k] + dba[j][k];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    dw_part[static_cast<size_t>(blockIdx.x) * D + i] = sdw[i];
    db_part[static_cast<size_t>(blockIdx.x) * D + i] = sdb[i];
  }
}

// dw (blockIdx.y 0) or db (1): the partials' column sums. Each of a block's
// kReduceGroups groups sums every kReduceGroups-th partial in order, then
// one thread adds the groups in order.
__global__ void __launch_bounds__(kReduceCols* kReduceGroups)
    reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                  float* __restrict__ dw, float* __restrict__ db, int parts, int D) {
  __shared__ float acc[kReduceGroups][kReduceCols + 1];
  const float* part = blockIdx.y ? db_part : dw_part;
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float sum = 0.f;
  if (col < D) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += kReduceGroups)
      sum += part[static_cast<size_t>(p) * D + col];
  }
  acc[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float total = acc[0][threadIdx.x];
    for (int g = 1; g < kReduceGroups; ++g) total += acc[g][threadIdx.x];
    (blockIdx.y ? db : dw)[col] = total;
  }
}

// Calls fn.template run<TIn, TOut, DS>() for the run's types and width: an
// instantiation for each of the model widths, the general one (DS = 0) for
// any other D up to kMaxD.
template <typename TIn, typename TOut, typename Fn>
cudaError_t by_width(int D, const Fn& fn) {
  switch (D) {
    case 384: return fn.template run<TIn, TOut, 384>();
    case 512: return fn.template run<TIn, TOut, 512>();
    case 768: return fn.template run<TIn, TOut, 768>();
    case 1024: return fn.template run<TIn, TOut, 1024>();
    default: return fn.template run<TIn, TOut, 0>();
  }
}

// dtype codes: 0 float32, 1 bfloat16
template <typename Fn>
cudaError_t dispatch(int in_dtype, int out_dtype, int D, const Fn& fn) {
  if (D < 1 || D > kMaxD || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  if (in_dtype == 0)
    return out_dtype == 0 ? by_width<float, float>(D, fn) : by_width<float, __nv_bfloat16>(D, fn);
  return out_dtype == 0 ? by_width<__nv_bfloat16, float>(D, fn)
                        : by_width<__nv_bfloat16, __nv_bfloat16>(D, fn);
}

struct Forward {
  const void *x, *res;
  const float *w, *b;
  void *y, *s;
  float *mean, *rstd;
  int rows, D;
  float eps;
  cudaStream_t stream;

  template <typename TIn, typename TOut, int DS>
  cudaError_t run() const {
    const int blocks = (rows + kWarps - 1) / kWarps;
    forward_kernel<TIn, TOut, DS><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const TIn*>(x), static_cast<const TIn*>(res), w, b, static_cast<TOut*>(y),
        static_cast<TIn*>(s), mean, rstd, rows, D, eps);
    return cudaGetLastError();
  }
};

struct Backward {
  const void *dy, *s;
  const float *mean, *rstd, *w;
  void* ds;
  float *dw, *db, *scratch;
  int parts, rows, D;
  cudaStream_t stream;

  template <typename TIn, typename TOut, int DS>
  cudaError_t run() const {
    float* dw_part = scratch;
    float* db_part = scratch + static_cast<size_t>(parts) * D;
    backward_kernel<TIn, TOut, DS><<<parts, kWarps * 32, 0, stream>>>(
        static_cast<const TOut*>(dy), static_cast<const TIn*>(s), mean, rstd, w,
        static_cast<TIn*>(ds), dw_part, db_part, rows, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((D + kReduceCols - 1) / kReduceCols, 2);
    reduce_kernel<<<grid, dim3(kReduceCols, kReduceGroups), 0, stream>>>(dw_part, db_part, dw,
                                                                        db, parts, D);
    return cudaGetLastError();
  }
};

}  // namespace wavjepa::layer_norm

namespace ln = wavjepa::layer_norm;

// y = LayerNorm(x [+ residual]) over rows of D. residual may be null; s
// (the rounded sum, x's type) is written only when both it and residual are
// given; mean and rstd (f32, one a row) only when given.
extern "C" int wavjepa_layer_norm_fwd(const void* x, const void* residual, const void* w,
                                      const void* b, void* y, void* s, void* mean, void* rstd,
                                      int rows, int D, int in_dtype, int out_dtype, float eps,
                                      void* stream) {
  const ln::Forward fn{x, residual, static_cast<const float*>(w), static_cast<const float*>(b),
                       y, s, static_cast<float*>(mean), static_cast<float*>(rstd), rows, D, eps,
                       static_cast<cudaStream_t>(stream)};
  return ln::dispatch(in_dtype, out_dtype, D, fn);
}

// ds, dw and db from dy and the forward's s, mean and rstd. scratch holds
// 2 · parts · D floats: the backward kernel's per-block partials, parts its
// grid (the caller fixes it, so that the same rows give the same bits).
extern "C" int wavjepa_layer_norm_bwd(const void* dy, const void* s, const void* mean,
                                      const void* rstd, const void* w, void* ds, void* dw,
                                      void* db, void* scratch, int parts, int rows, int D,
                                      int in_dtype, int out_dtype, void* stream) {
  if (parts < 1) return cudaErrorInvalidValue;
  const ln::Backward fn{dy, s, static_cast<const float*>(mean), static_cast<const float*>(rstd),
                        static_cast<const float*>(w), ds, static_cast<float*>(dw),
                        static_cast<float*>(db), static_cast<float*>(scratch), parts, rows, D,
                        static_cast<cudaStream_t>(stream)};
  return ln::dispatch(in_dtype, out_dtype, D, fn);
}
