"""Fixed sinusoidal position tables (numpy, float64).

The port's own copy of ``wavjepa_tpu/ops/pos_embed.py``'s 1-D and binaural
tables: for a 1-D grid the first half of the embedding is sin, the second
half cos, with frequencies ``1 / 10000**(2i/D)``. Callers cast to float32
(``JEPAConfig.pos_table``).
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions, any shape, flattened → (M, embed_dim) [sin | cos]."""
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """Table for integer positions 0..length-1 → (length, embed_dim)."""
    return get_1d_sincos_pos_embed_from_grid(
        embed_dim, np.arange(length, dtype=np.float64)
    )


def get_binaural_pos_embed(embed_dim: int, time_steps: int = 100) -> np.ndarray:
    """Two channels share a time code and differ in a channel code (left =
    zeros, right = the position-1 encoding); the channel tables are stacked
    along the sequence axis → (2·time_steps, embed_dim)."""
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    time_embed = get_1d_sincos_pos_embed(embed_dim // 2, time_steps)
    channel_left = np.zeros((time_steps, embed_dim // 2))
    channel_right = np.tile(
        get_1d_sincos_pos_embed(embed_dim // 2, 1), (time_steps, 1)
    )
    left = np.concatenate([time_embed, channel_left], axis=1)
    right = np.concatenate([time_embed, channel_right], axis=1)
    return np.concatenate([left, right], axis=0)
