"""Fixed-shape span-mask sampling on the device.

Counterpart of ``wavjepa_tpu/masking/span.py``. The span count is the
reference's probabilistic rounding ``floor(p·T/L + U)``; the starts are
``max_spans`` distinct positions drawn uniformly over ``[0, T − L)`` of which
the first ``num`` are active (a without-replacement sample is exchangeable,
so its prefix is a smaller uniform one). The random numbers come from a
``torch.Generator`` on the device that samples; they are not ``jax.random``'s,
so the tests hold the two samplers to each other by distribution.
``sample_span_mask_np`` is the host algorithm, for those tests.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def max_spans(n_times: int, mask_prob: float, mask_length: int) -> int:
    """Upper bound of the probabilistically rounded span count."""
    return int(math.floor(mask_prob * n_times / mask_length)) + 1


def sample_span_masks(
    generator: torch.Generator,
    batch_shape: tuple[int, ...],
    n_times: int,
    mask_prob: float,
    mask_length: int,
) -> torch.Tensor:
    """(*batch_shape, n_times) bool span masks, True = in a span, sampled on
    ``generator``'s device."""
    dev = generator.device
    n = math.prod(batch_shape)
    m = max_spans(n_times, mask_prob, mask_length)
    num = torch.floor(mask_prob * n_times / mask_length
                      + torch.rand(n, generator=generator, device=dev))
    # the m largest of iid uniform keys: a uniform m-subset in random order
    keys = torch.rand((n, n_times - mask_length), generator=generator, device=dev)
    starts = keys.topk(m, dim=-1).indices  # (n, m)
    active = torch.arange(m, device=dev) < num[:, None]
    t = torch.arange(n_times, device=dev)
    covered = ((t >= starts[..., None]) & (t < starts[..., None] + mask_length)
               & active[..., None])  # (n, m, T)
    return covered.any(dim=1).reshape(*batch_shape, n_times)


def filter_small_runs(mask: torch.Tensor, min_len: int) -> torch.Tensor:
    """Zero out runs of True shorter than ``min_len`` along the last axis."""
    change = torch.ones_like(mask)
    change[..., 1:] = mask[..., 1:] != mask[..., :-1]
    run_id = change.long().cumsum(dim=-1) - 1  # (..., T) in [0, T)
    run_len = torch.zeros(mask.shape, dtype=torch.long, device=mask.device)
    run_len.scatter_add_(-1, run_id, torch.ones_like(run_id))
    return mask & (run_len.gather(-1, run_id) >= min_len)


def sample_span_mask_np(
    rng: np.random.Generator, n_times: int, mask_prob: float, mask_length: int
) -> np.ndarray:
    """Host reference of the span sampler (the static, no-overlap path of
    fairseq's compute_mask_indices)."""
    num = int(mask_prob * n_times / mask_length + rng.random())
    mask = np.zeros(n_times, bool)
    if num == 0:
        return mask
    starts = rng.choice(n_times - mask_length, num, replace=False)
    for s in starts:
        mask[s : s + mask_length] = True
    return mask
