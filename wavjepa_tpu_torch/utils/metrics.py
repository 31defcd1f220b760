"""Training metrics: TensorBoard events, JSON lines, console lines, and
throughput.

Counterpart of ``wavjepa_tpu/utils/metrics.py``. ``Throughput`` counts clips
(what a data loader delivers) and crops (what the model trains on) apart:
each clip yields ``samples_per_audio`` crops.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricLogger:
    """Appends ``{"step": N, ...}`` to ``<log_dir>/metrics.jsonl``, prints
    ``[step N] key=value ...`` and, where ``tensorboardX`` imports, writes
    the same scalars as TensorBoard events into ``log_dir``; without it the
    JSON lines are the whole record."""

    def __init__(self, log_dir: Optional[str] = None, use_tensorboard: bool = True):
        self.writer = None
        self._jsonl = None
        if log_dir:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(log_dir) / "metrics.jsonl", "a")
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                except ImportError:
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self.writer = SummaryWriter(log_dir)

    def log(self, step: int, metrics: dict) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        if self.writer is not None:
            for key, value in scalars.items():
                self.writer.add_scalar(key, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        parts = " ".join(f"{k}={v:.5g}" for k, v in scalars.items())
        print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


class Throughput:
    """Clips and crops a second, over all ``n_cards`` data-parallel ranks
    and a card, and the mean step time, since ``start``, on the host clock.
    Read it after the device has finished the steps counted (the train loop
    reads it after fetching the metrics)."""

    def __init__(self, clips_per_step: int, crops_per_step: int, n_cards: int = 1):
        self.clips_per_step = clips_per_step
        self.crops_per_step = crops_per_step
        self.n_cards = n_cards
        self._t0 = time.perf_counter()
        self._steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self) -> None:
        self._steps += 1

    def rates(self) -> dict:
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        clips = self.clips_per_step * self._steps / elapsed
        crops = self.crops_per_step * self._steps / elapsed
        return {
            "clips_per_sec": clips,
            "crops_per_sec": crops,
            "clips_per_sec_per_card": clips / self.n_cards,
            "crops_per_sec_per_card": crops / self.n_cards,
            "step_time_ms": 1000.0 * elapsed / max(self._steps, 1),
        }
