"""Learning-rate and EMA-decay schedules, as plain functions of the step.

Counterpart of ``wavjepa_tpu/train/schedule.py``: HuggingFace's cosine with
linear warmup, stepped once per optimizer step, and the reference's linear
EMA-decay anneal.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """lr(t) = peak·t/warmup for t < warmup, then
    peak·max(0, ½(1 + cos(π·progress))): one half cosine, floor at 0."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return peak_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def ema_decay_schedule(start_decay: float = 0.999, end_decay: float = 0.99999,
                       anneal_end_step: int = 100_000) -> Schedule:
    """Linear anneal start → end over ``anneal_end_step`` steps, then
    constant."""

    def schedule(step: int) -> float:
        if step >= anneal_end_step:
            return end_decay
        return end_decay - (end_decay - start_decay) * (1.0 - step / anneal_end_step)

    return schedule
