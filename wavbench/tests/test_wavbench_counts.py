"""The frozen counts against the port's, and the trace reader."""

from __future__ import annotations

import gzip
import json

import pytest

from conftest import BENCH_DIR, load_json
from wavbench.count import attention, flops, trace


def _port_model(config_name: str):
    from wavbench.drivers.train import port_config

    cell = {"config": load_json(BENCH_DIR / "configs" / f"{config_name}.json"),
            "traffic": {"port_overrides": []}}
    return cell["config"]["model"], port_config(cell, 0).build_model_config()


@pytest.mark.parametrize("config_name,crops,tflop", [("wavjepa-base", 256, 46.28),
                                                     ("wavjepa-nat-base", 256, 95.61)])
def test_step_flops_equal_the_port(config_name, crops, tflop):
    from wavjepa_tpu_torch.utils import flops as port_flops

    m, port = _port_model(config_name)
    ours = flops.jepa_step_flops(m, crops)
    assert ours == port_flops.jepa_step_flops(port, crops)
    assert round(ours / 1e12, 2) == tflop


def test_window_flops_equal_the_port():
    from wavjepa_tpu_torch.utils import flops as port_flops

    m, port = _port_model("wavjepa-base")
    assert flops.encoder_path_flops(m) == port_flops.encoder_path_flops(port)
    assert round(sum(flops.encoder_path_flops(m)) / 1e9, 2) == 45.35


def test_attention_bound_is_the_larger_of_its_two():
    fwd = attention.call_seconds(16, 12, 200, 64, backward=False)
    ops = 4 * 16 * 12 * 200 * 200 * 64 / flops.H100_BF16_PEAK_FLOPS
    moved = (2 * 16 * 12 * 200 * 64 * 4 + 16 * 200 + 4 * 16 * 12 * 200) / 3.35e12
    assert fwd == max(ops, moved)
    assert attention.call_seconds(16, 12, 200, 64, True) > fwd
    m, _ = _port_model("wavjepa-base")
    # linear in the batch: the microbatch split does not change the bound
    assert attention.train_step_seconds(m, 256) == pytest.approx(
        16 * attention.train_step_seconds(m, 16))


def test_trace_reader_busy_idle_and_labels(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "w", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 60, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "other_thread", "ts": 0, "dur": 100, "tid": 2},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 30, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 30, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 10, "tid": 7},
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    out = trace.read(str(path), "w")
    assert out["wall_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(50e-6)  # 10-50 and 70-80
    assert out["kernels"] == 2
    assert out["device_ops"][0] == ["gemm", pytest.approx(60e-6)]
    idle = dict(out["idle_gaps"])
    assert idle["python"] == pytest.approx(10e-6 + 20e-6)  # 0-10 and 50-70
    assert idle["aten::copy_"] == pytest.approx(20e-6)  # 80-100, inside copy_ (60-90)
    assert set(idle) == {"python", "aten::copy_"}  # not the other thread's op
