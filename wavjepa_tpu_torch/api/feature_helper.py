"""Host-side input adaptation for the HEAR runtime: −14 dBFS RMS
normalisation, channel up/down-mixing and ragged-batch padding.

The port's own copy of ``wavjepa_tpu/api/feature_helper.py``, with the
reference's quirks kept: a (T, C) input with T > 100 is transposed, and
4-channel → stereo duplicates channel 0.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def normalize_audio_dbfs_np(audio: np.ndarray, target_dbfs: float = -14.0) -> np.ndarray:
    rms = float(np.sqrt(np.mean(np.square(audio))))
    if rms == 0:
        return audio
    gain = 10.0 ** ((target_dbfs - 20.0 * np.log10(rms)) / 20.0)
    return audio * gain


def adapt_channels(audio: np.ndarray, in_channels: int) -> np.ndarray:
    """(C_any, T) → (in_channels, T) with the reference's mixing rules."""
    if audio.ndim == 2 and audio.shape[0] > 100:
        audio = audio.T
    if audio.ndim == 1:
        audio = audio[None, :]
    c = audio.shape[0]
    if c == 1:
        if in_channels == 1:
            return audio
        if in_channels in (2, 4):
            return np.repeat(audio, in_channels, axis=0)
    elif c == 2:
        if in_channels == 1:
            return audio.mean(axis=0, keepdims=True)
        if in_channels == 2:
            return audio
    elif c == 4:
        if in_channels == 1:
            return audio[:1]
        if in_channels == 2:
            return np.repeat(audio[:1], 2, axis=0)
        if in_channels == 4:
            return audio
    raise ValueError(f"unsupported channel mapping {c} -> {in_channels}")


def prepare_batch(
    waveforms: Sequence[np.ndarray], in_channels: int, target_dbfs: float = -14.0
) -> np.ndarray:
    """Raw waveforms → (B, in_channels, T_max) normalised float32 batch,
    zero-padded at the end."""
    processed = []
    for audio in waveforms:
        audio = np.asarray(audio, np.float32)
        audio = adapt_channels(normalize_audio_dbfs_np(audio, target_dbfs), in_channels)
        processed.append(audio)
    t_max = max(a.shape[-1] for a in processed)
    batch = np.zeros((len(processed), in_channels, t_max), np.float32)
    for i, a in enumerate(processed):
        batch[i, :, : a.shape[-1]] = a
    return batch
