"""The WavLM embed cell on the CPU at a tiny size: the driver's whole run,
its per-layer readers, the benchmark's reference against the repository's
test reference, and the limits tool's faults and control far from the
program's reading."""

from __future__ import annotations

import copy
import importlib.util
import time

import pytest
import torch
from conftest import ROOT

from wavbench import harness
from wavbench.reference import wavlm as RW

TINY = {"conv_dim": [16] * 7, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128}


def tiny_wavlm_cell() -> dict:
    cell = copy.deepcopy(harness.load_cell("wavlm-large-embed"))
    cell["config"]["model"].update(TINY)
    cell["config"]["serving"]["dtype"] = "float32"
    cell["traffic"].update(utterances_per_request=3, mean_s=0.6, spread_s=0.3, max_s=1.5,
                           pool=4, longest_every=2, trace_requests=4, sample_requests=3)
    return cell


def test_reference_is_the_test_reference():
    spec = importlib.util.spec_from_file_location("wavlm_reference",
                                                  ROOT / "tests" / "wavlm_reference.py")
    tests_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests_ref)
    cell = tiny_wavlm_cell()
    m, pre = cell["config"]["model"], cell["config"]["preprocessor"]
    w = RW.make_weights(m, 2**31 + 3, torch.device("cpu"))
    wave = torch.randn(400 + 320 * 90, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = RW.encode(wave, w, m, pre)
        theirs = tests_ref.encode(wave, w, {**m, "do_normalize": pre["do_normalize"]})
    assert ours.shape == (91, 64)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)


def test_driver_runs_correct_and_its_readers_read():
    cell = tiny_wavlm_cell()
    driver = harness.driver("embed_wavlm")
    out = driver.run(cell, seed=2**31 + 7, seconds=0.3, trace=True, device=torch.device("cpu"),
                     t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["frames_off"]["value"] == 0
    assert out["checks"]["embed_gap"]["value"] < 1e-4  # f32 against f32
    assert set(out["end_to_end"]) == {"embed_audio_s_per_s", "embed_p95_ms", "setup_s"}
    record = out["record"]
    read = {m["name"]: harness.metric_reader(m["name"]).read(record)
            for m in harness.cell_metrics(cell, "per_layer")}
    assert read["mfu.wavlm_embed"] > 0
    # two requests of four hold the 1.5-s utterance: most of their tokens are padding
    assert 20 < read["padding_share.wavlm_embed"] < 80
    # the CPU's trace has no device time: the device readers find nothing
    assert read["relbias_roofline.wavlm_embed"] is None
    assert read["pos_conv_device_ms.wavlm_embed"] is None
    assert record["trace"]["counters"]["embed.tokens"] > 0


@pytest.mark.parametrize("variant", ["fp8", "nobias", "swap"])
def test_faults_and_control_read_far_from_the_program(variant):
    from wavbench.drivers import embed_wavlm as D
    from wavbench.reference import embed as E

    cell = tiny_wavlm_cell()
    m, pre = cell["config"]["model"], cell["config"]["preprocessor"]
    req = D.request_pool(cell["traffic"], 2**31 + 9)[0]
    w = RW.make_weights(m, 2**31 + 9, torch.device("cpu"))
    ref, _ = RW.scene_embeddings(req, w, m, pre, "cpu")
    if variant == "swap":
        var = ref.roll(1, dims=0)
    else:
        var, _ = RW.scene_embeddings(req, w, m, pre, "cpu", precision="fp8" if variant == "fp8"
                                     else "exact", bias=variant != "nobias")
    # the f32 program reads under 1e-4 here (above); the limit itself is read
    # on the card at full size, where bf16 reads ~10^3 times higher
    assert E.answer_gap(var, ref) > 0.05
