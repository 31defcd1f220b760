"""Synthetic waveform source: endless batches of random 10-s clips.

Counterpart of ``wavjepa_tpu/data/synthetic.py``, for smoke runs and
benchmarks: the model side is the real one, only decoding is skipped. Clips
are white noise through a one-pole low-pass, so the per-crop norms see a
decaying spectrum rather than flat noise.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_audio_batches(
    batch_size: int,
    in_channels: int = 1,
    seconds: float = 10.0,
    sr: int = 16000,
    seed: int = 0,
    start_batch: int = 0,
) -> Iterator[np.ndarray]:
    """(batch_size, in_channels, seconds·sr) f32 batches. Batch i is a pure
    function of (seed, i), so a resumed run restarts the stream at
    ``start_batch`` in O(1)."""
    length = int(seconds * sr)
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        i += 1
        # f32 draws: float64 generation is far slower on some hosts
        white = rng.standard_normal((batch_size, in_channels, length), dtype=np.float32)
        batch = white.copy()
        batch[..., 1:] = 0.7 * white[..., :-1] + 0.3 * white[..., 1:]
        yield batch
