"""The data-parallel train cell rehearsed on the CPU: four gloo ranks of the
tiny model, started by the driver as it starts NCCL ranks on the cards, the
global batch's readings against the reference, and the all-reduce span in
rank 0's traced tail."""

from __future__ import annotations

import time

import torch
from conftest import tiny_cell

from wavbench import harness


def tiny_dp_cell(world: int = 4) -> dict:
    cell = tiny_cell("base-pretrain-1pass")
    cell["name"] = "base-pretrain-dp4"
    cell["entry"] = dict(cell["entry"], name="base-pretrain-dp4", chips=world,
                         traffic="audioset-4x32x8-1pass")
    t = cell["traffic"]
    t.update(driver="train_dp", batch_clips=2 * world,
             port_overrides=[*t["port_overrides"], f"trainer.batch_size={2 * world}"])
    return cell


def test_four_gloo_ranks_run_correct_and_record_the_all_reduce():
    cell = tiny_dp_cell()
    out = harness.driver("train_dp").run(cell, seed=2**31 + 21, seconds=1.0, trace=True,
                                         device=torch.device("cpu"),
                                         t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["end_to_end"]["train_clips_per_s"] > 0
    # f32 against f32 over the global batch of 8 clips: the all-reduced step
    # is the one-process step on the whole batch
    assert out["checks"]["grad_diff"]["value"] < 1e-3
    record = out["record"]
    # the train cells' record, so that the train metrics read rank 0's card
    assert record["driver"] == "train" and record["world"] == 4
    assert "train.all_reduce" in record["trace"]["spans"]["idle_s_by_span"]
    for name in ("mfu.train", "data_wait_ms.train"):
        assert harness.metric_reader(name).read(record) is not None, name
    # no device on the CPU: the device's readers find nothing, and do not raise
    for name in ("allreduce_device_ms.train_dp", "launches_per_step.train", "idle_share.train",
                 "attention_roofline.train", "peak_mem_gib.train"):
        assert harness.metric_reader(name).read(record) is None, name
