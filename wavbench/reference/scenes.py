"""Plain acoustic scenes: RIR convolution, segmental-SNR noise, and the
Kaiser-windowed sinc resampler, in float64.

Written from WavJEPA-Nat's description of its scenes: the clean source
convolved with each channel of its room impulse response, the noise bed
convolved with each noise source's response and summed, scaled so that the
source-to-noise energy ratio over the noise's active span is the drawn SNR,
then resampled from the synthesis rate to the model's with torchaudio's
``sinc_interp_kaiser`` filter (64 zero crossings, rolloff 0.9476, beta
14.77). The convolutions are exact (FFT at a power-of-two length in
float64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROLLOFF = 0.9475937167399596
BETA = 14.769656459379492


def _full_convolve(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1] + k.shape[-1] - 1
    size = 1 << (n - 1).bit_length()
    return torch.fft.irfft(torch.fft.rfft(x, n=size) * torch.fft.rfft(k, n=size), n=size)[..., :n]


def kaiser_sinc(sr_in: int, sr_out: int, width: int = 64) -> tuple[np.ndarray, int, int]:
    """The filter on the upsampled grid (float64), and L (up), M (down)."""
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    rate = sr_in * up
    cutoff = ROLLOFF * min(sr_in, sr_out) / 2.0
    half = int(math.ceil(width / (2.0 * cutoff) * rate))
    t = np.arange(-half, half + 1, dtype=np.float64) / rate
    kernel = 2.0 * cutoff * np.sinc(2.0 * cutoff * t) * np.kaiser(2 * half + 1, BETA) / sr_in
    return kernel, up, down


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """(..., T) float64 → (..., ceil(T·sr_out/sr_in)) for an integer
    decimation (L = 1): y[j] = Σ_i x[i]·h[half + j·M − i]."""
    if sr_in == sr_out:
        return x
    kernel, up, down = kaiser_sinc(sr_in, sr_out)
    if up != 1:
        raise ValueError(f"only integer decimation is written here, not {sr_in} -> {sr_out}")
    half = kernel.size // 2
    full = _full_convolve(x, torch.from_numpy(kernel).to(x.device))
    t_out = int(math.ceil(x.shape[-1] * sr_out / sr_in))
    return full[..., half::down][..., :t_out]


def scene(batch: dict, n_channels: int, sr_in: int, sr_out: int) -> torch.Tensor:
    """A scene batch (``audio`` (B, T); ``source_rir`` (B, C, L);
    ``noise`` (B, T) with ``noise_rirs`` (B, S, C, L), ``snr``,
    ``noise_start``, ``noise_length``; any of these may be absent) →
    (B, n_channels, T·sr_out/sr_in) float64 on the batch's device."""
    src = batch["audio"].double()
    b, t = src.shape
    c = n_channels
    if "source_rir" in batch:
        wet = _full_convolve(src[:, None, :], batch["source_rir"][:, :c].double())[..., :t]
    else:
        wet = src[:, None, :].expand(b, c, t)
    if "noise" in batch:
        noise = batch["noise"].double()
        if "noise_rirs" in batch:  # one noise feeds every source: convolve their sum
            rirs = batch["noise_rirs"][:, :, :c].double().sum(dim=1)
            bed = _full_convolve(noise[:, None, :], rirs)[..., :t]
        else:
            bed = noise[:, None, :].expand(b, c, t)
        pos = torch.arange(t, device=src.device)[None, None, :]
        start = batch["noise_start"].long()[:, None, None]
        active = (pos >= start) & (pos < start + batch["noise_length"].long()[:, None, None])
        e_sig = (wet * active).square().sum(-1, keepdim=True)
        e_noise = (bed * active).square().sum(-1, keepdim=True)
        gain = torch.sqrt(e_sig / (e_noise + 1e-9) * 10.0 ** (-batch["snr"].double() / 10.0)
                          [:, None, None])
        wet = wet + gain * bed
    return resample(wet, sr_in, sr_out)
