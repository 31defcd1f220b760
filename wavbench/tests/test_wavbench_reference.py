"""The plain reference against the port at a tiny size on the CPU, and the
comparison failing where it must: the control (the reference in fp8 in the
program's place) and a run whose timed path is broken underneath."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell
from wavbench import harness, traffic
from wavbench.drivers import train as T

SEED = 2**31 + 17
CPU = torch.device("cpu")
# float32 against float32: rounding only
AGREE = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4, "ema_gap": 1e-4,
         "grad_diff": 1e-4, "grad_diff_median": 1e-4, "embed_gap": 1e-4}


def _run(cell):
    return harness.driver(cell["traffic"]["driver"]).run(
        cell, seed=SEED, seconds=0.05, trace=False, device=CPU, t_start=time.perf_counter())


@pytest.mark.parametrize("name", ["nat-pretrain", "base-pretrain-1pass", "base-embed"])
def test_reference_agrees_with_the_port(name):
    cell = tiny_cell(name)
    cell["workload"]["limits"] = {k: AGREE[k] for k in cell["workload"]["limits"]}
    out = _run(cell)
    assert out["correct"], out["checks"]


def test_traced_run_reads_its_per_layer_metrics():
    cell = tiny_cell("base-pretrain-1pass")
    out = harness.driver("train").run(cell, seed=SEED, seconds=0.05, trace=True, device=CPU,
                                      t_start=time.perf_counter())
    rec = out["record"]
    assert rec["trace"]["wall_s"] > 0 and rec["traced_steps"] == 1
    assert harness.metric_reader("data_wait_ms.train").read(rec) >= 0
    assert harness.metric_reader("mfu.train").read(rec) > 0
    # no device in the trace: the device's readers find nothing to read
    assert harness.metric_reader("idle_share.train").read(rec) is None
    assert harness.metric_reader("attention_roofline.train").read(rec) is None


@pytest.mark.parametrize("name", ["base-pretrain-1pass", "nat-pretrain"])
def test_fp8_control_fails_the_limits(name):
    cell = tiny_cell(name, limits=harness.load_cell(name)["workload"]["limits"])
    pool = traffic.train_pool(cell["traffic"], SEED)
    ref = T.reference_readings(cell, SEED, pool, CPU)
    control = T.reference_readings(cell, SEED, pool, CPU, precision="fp8")
    correct, checks = harness.judge(T.compare(control, ref), cell["workload"]["limits"])
    assert not correct, checks


def test_fp8_control_fails_the_embed_limit():
    from wavbench.reference import embed as E
    from wavbench.reference import model as M

    cell = tiny_cell("base-embed", limits=harness.load_cell("base-embed")["workload"]["limits"])
    m, t = cell["config"]["model"], cell["traffic"]
    clips = traffic.request_pool(t, SEED)[t["durations_s"][-1]][0]
    w = M.make_weights(m, SEED, CPU, training=False)
    gap = E.answer_gap(E.scene_embeddings(clips, w, m, CPU, precision="fp8"),
                       E.scene_embeddings(clips, w, m, CPU))
    assert not harness.judge({"embed_gap": gap}, cell["workload"]["limits"])[0]


def _unchanged(self, state, crops, ctx_mask, target_masks, visible_masks):
    state.step += 1
    return state, {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.0)}


def _half_batch(original):
    def prepare(self, cfg, audio, generator):
        crops, *masks = original(self, cfg, audio, generator)
        half = crops.shape[0] // 2
        return (crops[:half], *(m[:half] for m in masks))
    return prepare


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["base-pretrain-1pass", "nat-pretrain"])
def test_broken_train_step_is_not_correct(monkeypatch, fault, name):
    from wavjepa_tpu_torch.train.step import JEPATrainStep

    if fault == "unchanged":
        monkeypatch.setattr(JEPATrainStep, "step_on", _unchanged)
    else:
        monkeypatch.setattr(JEPATrainStep, "prepare", _half_batch(JEPATrainStep.prepare))
    cell = tiny_cell(name, limits=harness.load_cell(name)["workload"]["limits"])
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["nat-pretrain", "base-pretrain-1pass"])
def test_fault_after_the_first_steps_is_not_correct(monkeypatch, name):
    """A step that goes wrong only once the path is warm (here: it leaves
    its state unchanged from its fourth call on) passes the set-up check
    steps and is caught by their rerun after the window."""
    from wavjepa_tpu_torch.train.step import JEPATrainStep

    original, calls = JEPATrainStep.step_on, [0]

    def late(self, state, *args):
        calls[0] += 1
        return original(self, state, *args) if calls[0] <= 3 else _unchanged(self, state, *args)

    monkeypatch.setattr(JEPATrainStep, "step_on", late)
    cell = tiny_cell(name, limits=harness.load_cell(name)["workload"]["limits"])
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert all(c["value"] <= c["limit"] for k, c in out["checks"].items()
               if not k.endswith(".after")), out["checks"]


def test_altered_answer_is_not_correct(monkeypatch):
    from wavjepa_tpu_torch.api.runtime import RuntimeJEPA

    original = RuntimeJEPA.get_scene_embeddings
    monkeypatch.setattr(RuntimeJEPA, "get_scene_embeddings",
                        lambda self, audio: original(self, audio).roll(1, dims=0))
    cell = tiny_cell("base-embed", limits=harness.load_cell("base-embed")["workload"]["limits"])
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.card
def test_fp8_control_fails_at_the_cell_size(card):
    """The control at base-pretrain-1pass's own size, on the card."""
    from wavbench.tools.limits import train_readings

    cell = harness.load_cell("base-pretrain-1pass")
    readings = train_readings(cell, SEED, "fp8", card)
    assert not harness.judge(readings, cell["workload"]["limits"])[0], readings
