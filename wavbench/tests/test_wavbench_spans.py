"""``count/spans.py`` on a hand-built Chrome trace: device time by the
launching thread's span, autograd's launches put under the window thread's
span, idle gaps split by overlap."""

from __future__ import annotations

import gzip
import json

import pytest

from wavbench.count import spans

NAMES = ("train.step", "train.forward", "train.backward", "train.h2d")


def _span(name, ts, dur, tid):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(ts, corr, tid):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _device(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


@pytest.fixture
def trace_path(tmp_path):
    events = [
        _span("w", 0, 100, 1),
        _span("train.step", 10, 90, 1),
        _span("train.forward", 10, 30, 1),
        _span("train.backward", 40, 60, 1),
        _span("train.h2d", 0, 20, 3),  # the prefetch thread
        _launch(15, 1, 1),  # forward, main thread
        _device("gemm", 12, 18, 1),
        _launch(50, 2, 2),  # autograd's engine thread: no span of its own
        _device("gemm_bwd", 55, 10, 2),
        _launch(5, 3, 3),
        _device("Memcpy HtoD", 6, 2, 3, cat="gpu_memcpy"),
        _launch(3, 4, 1),  # before any span on the main thread
        _device("fill", 3, 1, 4, cat="gpu_memset"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 15, "dur": 3, "tid": 1},
        _span("Optimizer.step#AdamW.step", 45, 5, 1),  # a library's range: not the program's
        _launch(46, 5, 1),
        _device("adam", 65, 5, 5),
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_device_time_goes_to_the_launching_threads_span(trace_path):
    out = spans.read(trace_path, "w", NAMES)
    by = out["device_s_by_span"]
    assert by["train.forward"] == pytest.approx(18e-6)
    # launched off the main thread, and under a library's range
    assert by["train.backward"] == pytest.approx(10e-6 + 5e-6)
    assert by["train.h2d"] == pytest.approx(2e-6)
    assert set(by) == {"train.forward", "train.backward", "train.h2d"}
    assert out["device_s"] == pytest.approx(36e-6)
    assert out["uncovered_device_share"] == pytest.approx(1 / 36)  # the set at 3


def test_idle_gaps_are_split_by_overlap(trace_path):
    out = spans.read(trace_path, "w", NAMES)
    idle = out["idle_s_by_span"]
    # busy 3-4, 6-8, 12-30, 55-70: gaps 0-3, 4-6, 8-12, 30-55, 70-100
    assert idle["train.forward"] == pytest.approx((12 - 10 + 40 - 30) * 1e-6)
    assert idle["train.backward"] == pytest.approx((55 - 40 + 100 - 70) * 1e-6)
    assert "train.step" not in idle  # never the innermost over a gap
    assert out["idle_uncovered_s"] == pytest.approx((3 + 2 + 2) * 1e-6)  # before 10


def test_a_trace_without_the_window_is_refused(trace_path):
    with pytest.raises(ValueError, match="0 host ranges"):
        spans.read(trace_path, "missing", NAMES)
