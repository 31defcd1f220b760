"""Plain scene embeddings, as the HEAR runtime of WavJEPA defines them.

Each clip is brought to −14 dBFS RMS, padded to the next multiple of the
window (2.01 s; an exact multiple gains a whole window of padding), cut
into windows, and each window normalised over (channels, samples) to zero
mean and unit standard deviation (unbiased, std + 1e-5). The encoder runs
each window with the padded steps as masked keys; its outputs are joined
in time, cut to the clip's steps on a grid of whole seconds (the
reference's 100-Hz output rate, with the padding's steps truncated), and
averaged over time. All in float32 with TF32 off, in blocks of windows.
"""

from __future__ import annotations

import numpy as np
import torch

from wavbench.reference import model as M
from wavbench.reference.precision import PRECISIONS


def window_layout(samples: int, m: dict) -> tuple[int, int, int]:
    """(padding samples, windows, steps kept) of a clip of ``samples``."""
    unit = M.crop_samples(m)
    steps = M.frames_per_window(m)
    pad = unit - samples % unit
    padded = samples + pad
    windows = padded // unit
    whole_s = unit // m["sample_rate"]
    rate = int(steps / whole_s)
    kept = min(steps * int((padded / m["sample_rate"]) / whole_s)
               - int(pad / m["sample_rate"] * rate), steps * windows)
    return pad, windows, kept


def scene_embeddings(clips: np.ndarray, weights: dict, m: dict, device, block: int = 32,
                     precision: str = "exact") -> torch.Tensor:
    """(B, samples) mono clips → (B, encoder_dim) float32 on ``device``."""
    q = PRECISIONS[precision]
    x = clips.astype(np.float64)
    rms = np.sqrt(np.mean(np.square(x), axis=-1, keepdims=True))
    x = np.where(rms > 0, x * 10.0 ** ((-14.0 - 20.0 * np.log10(np.maximum(rms, 1e-300))) / 20.0),
                 x)
    b, samples = x.shape
    pad, windows, kept = window_layout(samples, m)
    unit, steps = M.crop_samples(m), M.frames_per_window(m)
    wins = torch.from_numpy(np.pad(x, ((0, 0), (0, pad))).reshape(b * windows, 1, unit))
    wins = wins.to(device)
    mean = wins.mean(dim=(1, 2), keepdim=True)
    std = ((wins - mean).square().sum(dim=(1, 2), keepdim=True) / (unit - 1)).sqrt()
    wins = ((wins - mean) / (std + 1e-5)).float()
    step_mask = torch.arange(windows * steps, device=device) >= kept
    masks = step_mask.reshape(windows, steps).repeat(b, 1)
    out = []
    with torch.no_grad(), M.float32_matmul():
        for lo in range(0, b * windows, block):
            out.append(M.encode(wins[lo:lo + block], weights, m, masks[lo:lo + block], q))
    emb = torch.cat(out).reshape(b, windows * steps, -1)[:, :kept]
    return emb.mean(dim=1)


def spread(emb: torch.Tensor) -> float:
    """The median distance of a request's embeddings from their mean: the
    scale on which clips differ."""
    d = (emb.double() - emb.double().mean(0, keepdim=True)).norm(dim=-1)
    return float(d.median())


def answer_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst clip's distance between the program's embedding and the
    reference's, against the request's spread."""
    dist = (program.double() - reference.double()).norm(dim=-1)
    return float(dist.max()) / max(spread(reference), 1e-30)
