"""Kaiser-windowed sinc resampling on the device, for scene synthesis.

Counterpart of ``wavjepa_tpu/data/resample.py:resample_jax``: the filter of
``data/resample.py`` (torchaudio's ``sinc_interp_kaiser``), which the JAX
package applies as one convolution over the zero-stuffed input (input
dilation L, stride M), here as L output phases of one ``F.conv1d`` with
stride M over the input itself (``F.conv1d`` has no input dilation). Any
rational rate; the Nat step uses 32 kHz → 16 kHz (L = 1, M = 2).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from wavjepa_tpu_torch.data.resample import BETA, ROLLOFF, _cached_kernel


def _polyphase_filters(kernel: np.ndarray, L: int, M: int) -> tuple[np.ndarray, int]:
    """The FIR on the upsampled grid as L filters over the input, one an
    output phase: y[j0 + s·L] = Σ_u x[s·M + u]·w[j0, u − u0] for j0 < L →
    (w (L, width) f32, u0 ≤ 0). Output j reads input i with tap
    kernel[half + j·M − i·L] (the zero-stuffed, centred convolution of
    ``resample_jax``); with j = j0 + s·L and i = s·M + u that is
    kernel[half + j0·M − u·L]."""
    half = kernel.size // 2
    taps = {}
    for j0 in range(L):
        # input s·M + u is read where 0 <= half + j0·M − u·L <= 2·half
        us = np.arange(-((half - j0 * M) // L), (half + j0 * M) // L + 1)
        taps[j0] = (us, kernel[half + j0 * M - us * L])
    u0 = min(int(us[0]) for us, _ in taps.values())
    width = max(int(us[-1]) for us, _ in taps.values()) - u0 + 1
    w = np.zeros((L, width), np.float32)
    for j0, (us, k) in taps.items():
        w[j0, us - u0] = k
    return w, u0


@functools.lru_cache(maxsize=32)
def _cached_polyphase(sr_in, sr_out, width, rolloff, beta, device: torch.device):
    """(w (L, 1, width) f32 on ``device``, u0, L, M), made once a device so
    that a step sends no filter from the host."""
    kernel, L, M = _cached_kernel(sr_in, sr_out, width, rolloff, beta)
    w, u0 = _polyphase_filters(kernel, L, M)
    return torch.from_numpy(w)[:, None, :].to(device), u0, L, M


def resample_torch(audio, sr_in: int, sr_out: int, lowpass_filter_width: int = 64,
                   rolloff: float = ROLLOFF, beta: float = BETA):
    """(B, C, T) tensor → (B, C, ceil(T·sr_out/sr_in)) f32 on its device, for
    any rational rate: ``resample_jax``'s dilated strided convolution as L
    output phases of one ``conv1d`` with stride M (no zero-stuffing). cuDNN
    runs it with TF32 off whatever the process's setting, so the filter sums
    in full float32. At equal rates the input comes back as it is."""
    if sr_in == sr_out:
        return audio
    weight, u0, L, M = _cached_polyphase(sr_in, sr_out, lowpass_filter_width, rolloff, beta,
                                         audio.device)
    b, c, t_in = audio.shape
    t_out = int(math.ceil(t_in * sr_out / sr_in))
    s_out = -(-t_out // L)  # outputs a phase
    width = weight.shape[-1]
    # input positions s·M + u0 … s·M + u0 + width − 1 for s < s_out
    right = max(0, (s_out - 1) * M + u0 + width - t_in)
    x = F.pad(audio.reshape(b * c, 1, t_in).float(), (-u0, right))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv1d(x, weight, stride=M)[..., :s_out]  # (B·C, L, s_out)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = y.transpose(1, 2).reshape(b * c, s_out * L)[:, :t_out]
    return y.reshape(b, c, t_out)
