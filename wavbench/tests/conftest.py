"""Shared pieces of the benchmark's CPU tests: tiny cells built from the
real configuration files, and the card marker.

Run from the root of the repository: ``python -m pytest wavbench/tests``.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

TINY_WIDTHS = {"encoder_layers": 2, "encoder_dim": 32, "encoder_heads": 4,
               "decoder_layers": 2, "decoder_dim": 16, "decoder_heads": 4}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_cell(name: str, limits: dict | None = None) -> dict:
    """The named cell of BENCHMARK.json at the tiny model's widths, in
    float32, on 2 clips of 3 s with 2 crops each (requests of 2 clips), so
    that a whole run takes seconds on the CPU."""
    from wavbench import harness

    cell = copy.deepcopy(harness.load_cell(name))
    cfg = cell["config"]
    cfg["model"].update(TINY_WIDTHS, dtype="float32")
    cfg["recipe"]["samples_per_audio"] = 2
    cfg["overrides"] = [*cfg.get("overrides", []), "trainer.size=tiny", "trainer.precision=f32",
                        "trainer.batch_size=2", "data.samples_per_audio=2"]
    t = cell["traffic"]
    if t["driver"] == "train":
        t.update(batch_clips=2, clip_seconds=3.0, trace_steps=1, reference_block=2)
    else:
        t.update(clips_per_request=2, durations_s=[1.0, 3.0], pool=2, trace_requests=2,
                 sample_requests=3)
    if limits is not None:
        cell["workload"]["limits"] = limits
    return cell


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())
