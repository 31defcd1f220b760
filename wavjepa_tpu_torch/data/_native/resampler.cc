// Polyphase FIR resampler (Kaiser-windowed sinc) for the host data path
// (data/resample.py resample_np). The inner product runs as contiguous FMA
// loops that the compiler vectorizes (-O3 -ffast-math -march=native).
//
// Semantics: centered polyphase decimation/interpolation identical to
// scipy.signal.resample_poly with this kernel —
//   y[j] = sum_k h[k] * x_up[j*M + half - k],   x_up = L-zero-stuffed x
// evaluated phase-wise so only real input samples are touched:
//   p    = (j*M + half) mod L
//   base = (j*M + half - p) / L
//   y[j] = sum_m h[p + m*L] * x[base - m]
// Per-phase taps are copied once per call into reversed contiguous arrays so
// the inner loop reads both taps and input forward (unit stride).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// x: rows * t_in (row-major), h: n_taps (odd, centered), y: rows * t_out.
// Returns 0 on success, nonzero on invalid arguments.
int wavjepa_resample_poly(const float* x, int64_t rows, int64_t t_in,
                          const float* h, int64_t n_taps, int64_t L, int64_t M,
                          float* y, int64_t t_out) {
  if (rows <= 0 || t_in <= 0 || n_taps <= 0 || L <= 0 || M <= 0 || t_out < 0)
    return 1;
  const int64_t half = n_taps / 2;

  // Build reversed per-phase tap tables: phase p has taps h[p], h[p+L], ...
  // stored reversed so y[j] = sum_i taps_rev[p][i] * x[first + i] with both
  // reads forward-contiguous.
  std::vector<int64_t> counts(L), offsets(L + 1, 0);
  for (int64_t p = 0; p < L; ++p) {
    counts[p] = (n_taps - p + L - 1) / L;
    offsets[p + 1] = offsets[p] + counts[p];
  }
  std::vector<float> taps_rev(offsets[L]);
  for (int64_t p = 0; p < L; ++p) {
    const int64_t c = counts[p];
    float* dst = taps_rev.data() + offsets[p];
    for (int64_t i = 0; i < c; ++i) dst[i] = h[p + (c - 1 - i) * L];
  }

  for (int64_t r = 0; r < rows; ++r) {
    const float* xr = x + r * t_in;
    float* yr = y + r * t_out;
    for (int64_t j = 0; j < t_out; ++j) {
      const int64_t pos = j * M + half;
      const int64_t p = pos % L;
      const int64_t base = pos / L;  // x index of the newest contributing tap
      const int64_t c = counts[p];
      // contributing x range: [base - (c-1), base], clipped to [0, t_in)
      int64_t first = base - (c - 1);
      int64_t i0 = 0;
      if (first < 0) {
        i0 = -first;
        first = 0;
      }
      int64_t last = base < t_in - 1 ? base : t_in - 1;
      const int64_t n = last - first + 1;
      const float* tp = taps_rev.data() + offsets[p] + i0;
      const float* xp = xr + first;
      float acc = 0.0f;
      for (int64_t i = 0; i < n; ++i) acc += tp[i] * xp[i];
      yr[j] = acc;
    }
  }
  return 0;
}

}  // extern "C"
