"""Acoustic scene synthesis on the device: RIR convolution and segmental-SNR
mixing, for WavJEPA-Nat's binaural and ambisonic scenes.

Counterpart of ``wavjepa_tpu/ops/scenes.py``, function for function, in
torch ops: the RIR convolutions are one batched ``torch.fft.rfft``/``irfft``
pair in float32 over a padded length chosen for cuFFT (``_fft_len``); the
noise sources are summed before their convolution (the same noise feeds
every source, so one convolution replaces one a source); absent noise
sources are all-zero RIR rows. ``generate_scene``'s four cases (RIR and
noise, RIR only, noise only, neither) are chosen by flags of the run, not of
the batch.

The device bank (``{"source_rir": (N, C, L)[, "noise_rirs": (N, M, C, L)]
[, "noise": (Nn, T)]}``) is gathered by per-clip indices, and refreshed in
place (``update_rir_bank``). int16-wired rows are undone by
``ops/audio.wire_to_f32``; their per-row peak gain cancels in the
segmental-SNR scale.
"""

from __future__ import annotations

from typing import Optional

import torch

from wavjepa_tpu_torch.ops.audio import wire_to_f32


def gather_scene_rirs(rir_bank: dict, idx: torch.Tensor) -> tuple:
    """Per-clip RIRs from the bank: (source_rir (B, C, L), noise_rirs
    (B, M, C, L) or None) for (B,) indices."""
    src = rir_bank["source_rir"].index_select(0, idx)
    noise = rir_bank["noise_rirs"].index_select(0, idx) if "noise_rirs" in rir_bank else None
    return src, noise


def place_noise_from_bank(noise_rows: torch.Tensor, idx: torch.Tensor,
                          start: torch.Tensor) -> torch.Tensor:
    """Placed noise from the bank's faded rows: row ``idx[b]`` rolled right
    by ``start[b]`` → (B, T) f32. Rows hold the faded noise left-aligned and
    zero-padded, and the host draws start + active length ≤ T, so the roll
    wraps only padding zeros."""
    rows = wire_to_f32(noise_rows.index_select(0, idx))
    t = rows.shape[-1]
    src = (torch.arange(t, device=rows.device)[None, :] - start.to(torch.long)[:, None]) % t
    return torch.gather(rows, 1, src)


@torch.no_grad()
def update_rir_bank(rir_bank: dict, slots: dict, rows: dict) -> dict:
    """Write refreshed rows into the bank in place: for each key of
    ``rows``, ``rows[key]`` (k, ...) into the (k,) ``slots[key]``. int16
    rows go into an int16 bank as they are and into an f32 bank through
    ``wire_to_f32``. Returns the bank."""
    for key, new in rows.items():
        bank = rir_bank[key]
        if new.dtype != bank.dtype:
            new = wire_to_f32(new).to(bank.dtype)
        bank.index_copy_(0, slots[key].to(device=bank.device, dtype=torch.long),
                         new.to(bank.device))
    return rir_bank


def _smooth7(n: int) -> bool:
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def _fft_len(n: int) -> int:
    """Padded FFT length ≥ n: the smallest 2^a·3^b·5^c·7^d ≥ n, the lengths
    cuFFT transforms with its fast radix kernels (383999 → 384000 =
    2^10·3·5^3 at the Nat scene shape, T = 320000, L = 64000). Any n ≥
    t + l − 1 gives the exact linear convolution."""
    m = max(1, n)
    while not _smooth7(m):
        m += 1
    return m


def fft_convolve_full_trunc(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Full-mode linear convolution along the last axis, cut to the input
    length: ``fftconvolve(x, kernel, mode="full")[..., :T]``. x (..., T),
    kernel broadcastable (..., L) → (..., T) f32."""
    t, length = x.shape[-1], kernel.shape[-1]
    n = _fft_len(t + length - 1)
    xf = torch.fft.rfft(x.float(), n=n)
    kf = torch.fft.rfft(kernel.float(), n=n)
    return torch.fft.irfft(xf * kf, n=n)[..., :t]


def convolve_with_rir(waveform: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """(B, T) waveforms with (B, C, L) RIRs → (B, C, T)."""
    return fft_convolve_full_trunc(waveform[:, None, :], rir)


def aggregate_noise(noise_rirs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The scene's noise bed: Σ_n conv(noise, rir_n) = conv(noise, Σ_n rir_n)
    (the same noise feeds every source; zero rows add nothing).
    noise_rirs (B, M, C, L), noise (B, T) → (B, C, T)."""
    return fft_convolve_full_trunc(noise[:, None, :], noise_rirs.sum(dim=1))


def add_noise(source: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor,
              noise_start: torch.Tensor, noise_length: torch.Tensor) -> torch.Tensor:
    """Segmental-SNR mixing: scale the noise so that over its active span
    [start, start + length) SNR(source, a·noise) = snr_db, then add.
    source, noise (B, C, T); snr_db, noise_start, noise_length (B,)."""
    b, _, t = source.shape
    tt = torch.arange(t, device=source.device)[None, None, :]
    start = noise_start.reshape(b, 1, 1)
    active = (tt >= start) & (tt < start + noise_length.reshape(b, 1, 1))
    zero = source.new_zeros(())
    e_sig = torch.where(active, source, zero).square().sum(dim=-1, keepdim=True)
    e_noise = torch.where(active, noise, zero).square().sum(dim=-1, keepdim=True)
    scale = 10.0 ** (-snr_db.reshape(b, 1, 1).float() / 10.0)
    a = torch.sqrt(e_sig / (e_noise + 1e-9) * scale)
    return source + a * noise


def generate_scene(source: torch.Tensor, source_rir: Optional[torch.Tensor],
                   noise: Optional[torch.Tensor], noise_rirs: Optional[torch.Tensor],
                   noise_start: Optional[torch.Tensor], noise_length: Optional[torch.Tensor],
                   snr_db: Optional[torch.Tensor], with_rir: bool, with_noise: bool,
                   n_channels: int = 1) -> torch.Tensor:
    """The (B, n_channels, T) scene from a clean (B, T) batch: the
    reverberant source plus its reverberant noise bed at the target SNR
    (RIR and noise), the reverberant source (RIR only), the dry source plus
    the dry noise at the SNR (noise only), or the source itself. The first
    ``n_channels`` RIR channels are kept (1: the denoiser's mono slice; 2
    binaural, 4 ambisonic: Nat)."""
    c = n_channels
    b, t = source.shape
    if not with_rir and not with_noise:
        return source[:, None, :].expand(b, c, t)
    if with_rir:
        wet = convolve_with_rir(source, source_rir[:, :c, :])
        if not with_noise:
            return wet
        bed = aggregate_noise(noise_rirs[:, :, :c, :], noise)
        return add_noise(wet, bed, snr_db, noise_start, noise_length)
    dry = source[:, None, :].expand(b, c, t)
    bed = noise[:, None, :].expand(b, c, t)
    return add_noise(dry, bed, snr_db, noise_start, noise_length)
