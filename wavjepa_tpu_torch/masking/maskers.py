"""JEPA block maskers with fixed shapes, sampled on the device.

Counterpart of ``wavjepa_tpu/masking/maskers.py``. The reference's
per-sample rejection loop becomes K candidates drawn at once, of which the
first passing the visible-ratio cutoff is kept (else the best ratio).

Return convention (the reference's):
  ctx_mask       (B, T)    True = NOT context (the encoder's key-padding mask)
  target_masks   (B, N, T) True = target position of that group
  visible_masks  (B, N, T) True = masked for the predictor
                           (= ctx_mask XOR target_masks)

With ``channel_based_masking`` and C > 1 channels the masks are tiled
channel-major, the token order of the channel-wise frontend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavjepa_tpu_torch.masking.span import filter_small_runs, sample_span_masks


@dataclasses.dataclass(frozen=True)
class TimeInverseMaskConfig:
    """configs/masker/AudioSet.yaml defaults."""

    target_masks_per_context: int = 4
    context_mask_prob: float = 0.65
    context_mask_length: int = 10
    target_prob: float = 0.25
    target_length: int = 10
    ratio_cutoff: float = 0.1
    channel_based_masking: bool = False
    n_candidates: int = 4  # parallel replacement for the rejection loop


@dataclasses.dataclass(frozen=True)
class SpeechMaskConfig:
    """configs/masker/LibriSpeech.yaml defaults."""

    target_masks_per_context: int = 4
    target_prob: float = 0.1
    target_length: int = 10
    min_context_len: int = 5
    ratio_cutoff: float = 0.5
    channel_based_masking: bool = False
    n_candidates: int = 4


def _select_candidate(ctx_visible, targets, cutoff):
    """Per row, the first candidate whose visible ratio is ≥ cutoff, else
    the best ratio. ctx_visible (B, K, T), targets (B, K, N, T)."""
    ratios = ctx_visible.float().mean(dim=-1)  # (B, K)
    ok = ratios >= cutoff
    idx = torch.where(ok.any(dim=1), ok.int().argmax(dim=1), ratios.argmax(dim=1))
    rows = torch.arange(ctx_visible.shape[0], device=ctx_visible.device)
    return ctx_visible[rows, idx], targets[rows, idx]


def _finalize(ctx_visible, targets, in_channels: int, channel_based: bool):
    ctx_mask = ~ctx_visible
    visible = ctx_mask[:, None, :] ^ targets
    if channel_based and in_channels > 1:
        ctx_mask, targets, visible = _tile_channels(ctx_mask, targets, visible, in_channels)
    return ctx_mask, targets, visible


def _tile_channels(ctx_mask, targets, visible, in_channels: int):
    """Repeat masks per channel, channel-major: (B, T) → (B, C·T) and
    (B, N, T) → (B, N, C·T)."""
    c = in_channels
    b, n, t = targets.shape
    return (ctx_mask[:, None, :].repeat(1, c, 1).reshape(b, c * t),
            targets[:, :, None, :].repeat(1, 1, c, 1).reshape(b, n, c * t),
            visible[:, :, None, :].repeat(1, 1, c, 1).reshape(b, n, c * t))


def time_inverse_block_masks(
    generator: torch.Generator,
    batch_size: int,
    n_times: int,
    in_channels: int = 1,
    cfg: TimeInverseMaskConfig = TimeInverseMaskConfig(),
):
    """(ctx_mask, target_masks, visible_masks) for a batch, on the
    generator's device. ``n_times`` counts all tokens; each channel has
    ``n_times // in_channels``."""
    t = n_times // in_channels
    k, n = cfg.n_candidates, cfg.target_masks_per_context
    ctx_cov = sample_span_masks(generator, (batch_size, k), t, cfg.context_mask_prob,
                                cfg.context_mask_length)
    targets = sample_span_masks(generator, (batch_size, k, n), t, cfg.target_prob,
                                cfg.target_length)
    ctx_visible = ~ctx_cov & ~targets.any(dim=2)
    ctx_sel, tgt_sel = _select_candidate(ctx_visible, targets, cfg.ratio_cutoff)
    return _finalize(ctx_sel, tgt_sel, in_channels, cfg.channel_based_masking)


def speech_masks(
    generator: torch.Generator,
    batch_size: int,
    n_times: int,
    in_channels: int = 1,
    cfg: SpeechMaskConfig = SpeechMaskConfig(),
):
    """SpeechMasker: context = complement of the targets with runs shorter
    than ``min_context_len`` dropped, ratio cutoff as above."""
    t = n_times // in_channels
    k, n = cfg.n_candidates, cfg.target_masks_per_context
    targets = sample_span_masks(generator, (batch_size, k, n), t, cfg.target_prob,
                                cfg.target_length)
    ctx_visible = filter_small_runs(~targets.any(dim=2), cfg.min_context_len)
    ctx_sel, tgt_sel = _select_candidate(ctx_visible, targets, cfg.ratio_cutoff)
    return _finalize(ctx_sel, tgt_sel, in_channels, cfg.channel_based_masking)


def format_mask(mask, masked_char: str = "█", visible_char: str = "·") -> str:
    """A boolean mask row as text: True (masked) → block, False → dot."""
    row = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask).astype(bool)
    if row.ndim > 1:
        return "\n".join(format_mask(r, masked_char, visible_char) for r in row)
    return "".join(masked_char if m else visible_char for m in row)
