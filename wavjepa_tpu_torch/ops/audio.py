"""Audio utilities of the train step: wire format, crops, per-crop norm.

Counterpart of the parts of ``wavjepa_tpu/ops/audio.py`` and
``wavjepa_tpu/ops/scenes.py`` that the mono SSL step uses. Random crop
offsets come from a ``torch.Generator``; ``crops_at`` takes given offsets,
so a test can feed the same crops to both packages.
"""

from __future__ import annotations

from typing import Optional

import torch


def wire_to_f32(audio: torch.Tensor) -> torch.Tensor:
    """int16 wire batches (the host pipeline's transfer format) → f32 in
    [-1, 1] by ×1/32767; float input is cast to f32 unchanged. The scale
    is removed by the per-crop instance norm that follows."""
    if audio.dtype == torch.int16:
        return audio.float() * (1.0 / 32767.0)
    return audio.float()


def instance_normalize(audio: torch.Tensor, dims=(-2, -1), eps: float = 1e-5) -> torch.Tensor:
    """Per-crop zero mean and unit std over ``dims``: unbiased (n − 1)
    variance and ``(x − μ) / (σ + eps)``, as torch's ``Tensor.std`` in the
    reference's batch preparation."""
    mean = audio.mean(dim=dims, keepdim=True)
    n = 1
    for d in dims:
        n *= audio.shape[d]
    var = (audio - mean).square().sum(dim=dims, keepdim=True) / max(n - 1, 1)
    return (audio - mean) / (var.sqrt() + eps)


def crops_at(audio: torch.Tensor, starts: torch.Tensor, crop_len: int) -> torch.Tensor:
    """(B, C, L) audio and (B, n) start offsets → (B, n, C, crop_len)."""
    b, c, _ = audio.shape
    idx = starts[:, :, None] + torch.arange(crop_len, device=audio.device)  # (B, n, crop)
    idx = idx[:, :, None, :].expand(b, starts.shape[1], c, crop_len)
    src = audio[:, None].expand(b, starts.shape[1], c, audio.shape[-1])
    return torch.gather(src, 3, idx)


def random_starts(generator: torch.Generator, audio: torch.Tensor, crop_len: int,
                  n_crops: int, n_clips: Optional[int] = None) -> torch.Tensor:
    """(n_clips, n_crops) crop starts, uniform over [0, L − crop_len], on
    ``audio``'s device; ``n_clips`` is ``audio``'s batch unless given (a
    data-parallel step draws for the global batch, of which ``audio`` holds
    a rank's rows)."""
    b, _, length = audio.shape
    return torch.randint(0, length - crop_len + 1, (n_clips or b, n_crops),
                         generator=generator, device=generator.device).to(audio.device)


def random_crops(generator: torch.Generator, audio: torch.Tensor, crop_len: int,
                 n_crops: int) -> torch.Tensor:
    """``n_crops`` random ``crop_len`` windows of each clip →
    (B, n_crops, C, crop_len)."""
    return crops_at(audio, random_starts(generator, audio, crop_len, n_crops), crop_len)
