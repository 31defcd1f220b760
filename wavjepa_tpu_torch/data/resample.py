"""Kaiser-windowed sinc resampling on the host.

Counterpart of the host half of ``wavjepa_tpu/data/resample.py``: the
filter of torchaudio's ``sinc_interp_kaiser`` (lowpass_filter_width 64,
rolloff ≈ 0.9476, β ≈ 14.77), applied as a rational-rate polyphase FIR by
the native resampler (``data/_native/resampler.cc``). ``resample_np_plain``
is the same filter through ``scipy.signal.resample_poly``: the plain version
the native one is held against, never a fallback for it. The device half,
for scene synthesis in the step, is ``ops/resample.py`` (this package's
``data`` modules import no torch).
"""

from __future__ import annotations

import functools
import math

import numpy as np

ROLLOFF = 0.9475937167399596
BETA = 14.769656459379492


def _kaiser_sinc_kernel(sr_in: int, sr_out: int, lowpass_filter_width: int = 64,
                        rolloff: float = ROLLOFF, beta: float = BETA
                        ) -> tuple[np.ndarray, int, int]:
    """FIR on the upsampled (sr_in·L) grid → (kernel f32, L, M).

    Cutoff f_c = rolloff·min(sr)/2; half-width = lowpass_filter_width
    zero-crossings of the cutoff sinc; Kaiser(β) window; passband gain 1.
    """
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    rate_up = sr_in * L
    f_c = rolloff * min(sr_in, sr_out) / 2.0
    half_width_s = lowpass_filter_width / (2.0 * f_c)
    half_taps = int(math.ceil(half_width_s * rate_up))
    t = np.arange(-half_taps, half_taps + 1, dtype=np.float64) / rate_up
    kernel = 2.0 * f_c * np.sinc(2.0 * f_c * t)
    window = np.kaiser(kernel.size, beta)
    # band-limited reconstruction: y(t) = Σ x[n]·(2f_c/sr_in)·sinc(2f_c(t − n/sr_in));
    # zero-stuffing needs no extra gain, since only real samples enter the sum
    kernel = kernel * window / sr_in
    return kernel.astype(np.float32), L, M


@functools.lru_cache(maxsize=32)
def _cached_kernel(sr_in, sr_out, width, rolloff, beta):
    return _kaiser_sinc_kernel(sr_in, sr_out, width, rolloff, beta)


def _prepare(audio, sr_in, sr_out, width, rolloff, beta):
    kernel, L, M = _cached_kernel(sr_in, sr_out, width, rolloff, beta)
    t_in = audio.shape[-1]
    t_out = int(math.ceil(t_in * sr_out / sr_in))
    return audio.reshape(-1, t_in).astype(np.float32), kernel, L, M, t_out


def resample_np(audio: np.ndarray, sr_in: int, sr_out: int, lowpass_filter_width: int = 64,
                rolloff: float = ROLLOFF, beta: float = BETA) -> np.ndarray:
    """(..., T) → (..., ceil(T·sr_out/sr_in)) f32 on the native polyphase
    resampler, which is built at first use; a failed build raises. At equal
    rates the input comes back as it is."""
    if sr_in == sr_out:
        return audio
    from wavjepa_tpu_torch.data._native.resample_native import resample_poly_native

    flat, kernel, L, M, t_out = _prepare(audio, sr_in, sr_out, lowpass_filter_width,
                                         rolloff, beta)
    out = resample_poly_native(flat, kernel, L, M, t_out)
    return out.reshape(*audio.shape[:-1], t_out)


def resample_np_plain(audio: np.ndarray, sr_in: int, sr_out: int,
                      lowpass_filter_width: int = 64, rolloff: float = ROLLOFF,
                      beta: float = BETA) -> np.ndarray:
    """``resample_np`` through ``scipy.signal.resample_poly`` (which scales
    a given window by ``up``, hence kernel / L): the plain version that the
    tests and ``chip_smoke.py`` hold the native resampler against."""
    if sr_in == sr_out:
        return audio
    from scipy.signal import resample_poly

    flat, kernel, L, M, t_out = _prepare(audio, sr_in, sr_out, lowpass_filter_width,
                                         rolloff, beta)
    out = resample_poly(flat, L, M, axis=-1, window=kernel / L).astype(np.float32)
    if out.shape[-1] < t_out:
        out = np.pad(out, ((0, 0), (0, t_out - out.shape[-1])))
    return out[:, :t_out].reshape(*audio.shape[:-1], t_out)
