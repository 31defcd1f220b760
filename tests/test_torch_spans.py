"""The port's phase spans and counters (``utils/profiling.span``, ``count``,
``recording``): off without a recording, parents and threads while one is
open, the phases the train step, the prefetch thread and the serving entry
record, the step unchanged by recording, one recording at a time, and the
spans in ``trace``'s Chrome trace."""

import gzip
import json
import threading

import numpy as np
import pytest
import torch

from wavjepa_tpu_torch.api.runtime import RuntimeJEPA, chunk_padding
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops.conv_frontend import WAVJEPA_CONV_SPEC
from wavjepa_tpu_torch.train.loop import prefetch_to_device
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    NatSceneConfig,
    OptimizerConfig,
    make_jepa_train_step,
    make_optimizer,
)
from wavjepa_tpu_torch.utils import profiling

TINY = dict(conv_spec=((16, 10, 5), (16, 3, 2)), size="tiny", sample_rate=1600,
            process_seconds=0.201, average_top_k_layers=2)
NAT = dict(in_channels=2, extractor="conv_channel", pos_embed="binaural")
MASK = dict(target_masks_per_context=2, context_mask_prob=0.5, context_mask_length=4,
            target_prob=0.2, target_length=4)
OPT = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
B, T32, RIR = 2, 3200, 320


def _state(cfg: JEPAConfig, seed=0) -> TrainState:
    model = JEPA(cfg)
    model.init_parameters(torch.Generator().manual_seed(seed))
    return TrainState.create(model, make_optimizer(OPT, model))


def _clips(seed=0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, 1, 3 * 1600)).astype(np.float32))


def _scene_batch(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    rirs = np.zeros((B, 2, RIR), np.float32)
    rirs[:, :, 0] = 1.0
    nrirs = np.zeros((B, 3, 2, RIR), np.float32)
    nrirs[:, 0, :, 0] = 1.0
    batch = {"audio": rng.standard_normal((B, T32)).astype(np.float32), "source_rir": rirs,
             "noise": rng.standard_normal((B, T32)).astype(np.float32), "noise_rirs": nrirs,
             "noise_start": np.array([0, 400], np.int32),
             "noise_length": np.array([T32, 2000], np.int32),
             "snr": np.array([2.0, -3.0], np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _step(nat: bool, accum: int):
    mask = TimeInverseMaskConfig(**MASK, channel_based_masking=nat)
    scene = NatSceneConfig(n_channels=2, original_sr=3200) if nat else None
    return make_jepa_train_step(OPT, nr_samples_per_audio=2, masker_cfg=mask,
                                accum_steps=accum, scene_cfg=scene)


def test_spans_are_off_without_a_recording():
    assert profiling.span("a", step=1) is profiling.span("b")  # one shared no-op
    profiling.count("n", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("off.phase"):
            torch.ones(4).sum()
    assert "off.phase" not in {e.name for e in prof.events()}
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_nested_spans_keep_parents_roots_and_threads():
    with profiling.recording() as rec:
        with profiling.span("outer", request=7) as outer:
            with profiling.span("inner") as inner:
                with profiling.span("leaf"):
                    profiling.count("tokens", 5)

            def work():
                with profiling.span("elsewhere", request=8):
                    with profiling.span("elsewhere.child"):
                        profiling.count("tokens", 2)

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans[:3]] == ["leaf", "inner", "elsewhere.child"]
    assert by["outer"].parent is None and by["inner"].parent == outer.id
    assert by["leaf"].parent == inner.id
    assert all(by[n].root == {"request": 7} for n in ("outer", "inner", "leaf"))
    assert by["outer"].attrs == {"request": 7} and by["inner"].attrs == {}
    main = threading.get_ident()
    assert {by[n].thread for n in ("outer", "inner", "leaf")} == {main}
    # the other thread's stack is its own: its first span is a root there
    assert by["elsewhere"].parent is None and by["elsewhere"].thread != main
    assert by["elsewhere.child"].parent == by["elsewhere"].id
    assert by["elsewhere.child"].root == {"request": 8}
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["leaf"].end_ns <= \
        by["outer"].end_ns
    assert rec.counters == {"tokens": 7}
    assert rec.totals()["leaf"]["count"] == 1 and rec.totals()["outer"]["s"] > 0


@pytest.mark.parametrize("nat", [False, True], ids=["mono", "nat"])
def test_step_records_its_phases(nat):
    cfg = JEPAConfig(**TINY, **(NAT if nat else {}))
    state, step = _state(cfg), _step(nat, accum=2)
    state.step = 41
    audio = _scene_batch() if nat else _clips()
    with profiling.recording() as rec:
        step(state, audio, torch.Generator().manual_seed(0))
    names = [s.name for s in rec.spans]
    by_id = {s.id: s for s in rec.spans}
    (root,) = [s for s in rec.spans if s.name == "train.step"]
    assert root.attrs == {"step": 41} and root.parent is None
    assert all(s.root == {"step": 41} for s in rec.spans)  # one step, one identifier
    micro = [s for s in rec.spans if s.name == "train.microbatch"]
    assert [m.attrs["index"] for m in micro] == [0, 1]
    assert all(m.parent == root.id for m in micro)
    for m in micro:
        kids = [s.name for s in rec.spans if s.parent == m.id]
        assert kids == ["train.forward", "train.backward"]
    assert names.count("train.forward") == names.count("train.backward") == 2
    assert names.count("train.update") == names.count("train.prepare") == 1
    assert names.count("scene_synthesis") == (1 if nat else 0)
    for name in ("train.prepare", "train.update") + (("scene_synthesis",) if nat else ()):
        (s,) = [s for s in rec.spans if s.name == name]
        assert by_id[s.parent] is root


def test_step_is_bitwise_equal_with_and_without_a_recording():
    cfg = JEPAConfig(**TINY)
    out = []
    for record in (False, True):
        state, step = _state(cfg), _step(False, accum=2)
        with profiling.recording() if record else profiling.span("off"):
            _, m = step(state, _clips(), torch.Generator().manual_seed(3))
        weights = torch.cat([p.detach().flatten() for p in state.model.parameters()])
        teacher = torch.cat([p.flatten() for p in state.teacher_encoder.parameters()])
        out.append((m["loss"], m["grad_norm"], weights, teacher))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_prefetch_records_the_wait_and_the_copy_on_its_thread():
    batches = [np.full((2, 3), i, np.float32) for i in range(3)]
    with profiling.recording() as rec:
        got = [int(b[0, 0]) for b in prefetch_to_device(iter(batches), torch.device("cpu"))]
    assert got == [0, 1, 2]
    waits = [s for s in rec.spans if s.name == "train.data_wait"]
    copies = [s for s in rec.spans if s.name == "train.h2d"]
    assert len(waits) == 4  # three batches and the end of the stream
    assert len(copies) == 3
    assert {s.thread for s in waits} == {threading.get_ident()}
    assert {s.thread for s in copies} != {threading.get_ident()}


# the published frontend's strides at the tiny widths: 200 tokens a 2.01-s window at 16 kHz
SERVE = dict(conv_spec=tuple((16, k, s) for _, k, s in WAVJEPA_CONV_SPEC), size="tiny",
             average_top_k_layers=2)


@pytest.fixture(scope="module")
def runtime():
    return RuntimeJEPA(JEPAConfig(**SERVE), device="cpu")


# a window is int(16000 * 2.01) = 32159 samples
@pytest.mark.parametrize("seconds,cut_off,total", [(1.0, 100, 200), (5.0, 498, 600),
                                                   (10.0, 996, 1000)])
def test_runtime_records_a_request_and_counts_its_tokens(runtime, seconds, cut_off, total):
    assert (runtime.unit_frames, runtime.output_steps) == (32159, 200)
    frames = int(seconds * 16000)
    assert chunk_padding(frames, runtime.unit_frames, 16000, 200)[2:] == (cut_off, total)
    clips = np.random.default_rng(0).standard_normal((2, frames)).astype(np.float32)
    with profiling.recording() as rec:
        emb = runtime.get_scene_embeddings(clips)
    assert emb.shape == (2, 32)
    (root,) = [s for s in rec.spans if s.name == "embed.request"]
    assert root.parent is None and "request" in root.attrs
    kids = [s.name for s in rec.spans if s.parent == root.id]
    assert kids == ["embed.prepare", "embed.h2d", "embed.encode"]
    # one encoder forward: feature_norms, two norms a layer and the final one
    layers = runtime.config.encoder_layers
    assert rec.counters == {"embed.tokens": 2 * total, "embed.padded_tokens": 2 * (total - cut_off),
                            "layer_norm.plain": 2 * layers + 2}


def test_padding_share_of_the_mixed_requests():
    """One request of each of 1, 5 and 10 s pads 206 of 1800 tokens a clip."""
    rt = RuntimeJEPA(JEPAConfig(**SERVE), device="cpu")
    with profiling.recording() as rec:
        for seconds in (1.0, 5.0, 10.0):
            rt.get_timestamp_embeddings(np.zeros((1, int(seconds * 16000)), np.float32))
    requests = [s.attrs["request"] for s in rec.spans if s.name == "embed.request"]
    assert requests == [0, 1, 2]
    share = 100 * rec.counters["embed.padded_tokens"] / rec.counters["embed.tokens"]
    assert share == pytest.approx(100 * 206 / 1800) and round(share, 2) == 11.44


def test_one_recording_is_open_at_a_time():
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.recording():
                pass
        with profiling.span("still.recorded"):
            profiling.count("n", 1)
    assert [s.name for s in rec.spans] == ["still.recorded"] and rec.counters == {"n": 1}
    with profiling.recording() as again:  # closed: a new one opens
        pass
    assert again is not rec and profiling.span("x") is profiling.span("y")


def _annotations(path) -> dict:
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return {e["name"]: e for e in events if e.get("cat") == "user_annotation"}


def test_trace_inside_a_recording_records_into_it(tmp_path):
    with profiling.recording() as rec, profiling.trace(str(tmp_path), name="inside"):
        with profiling.span("phase.outer"):
            profiling.count("n", 2)
    assert [s.name for s in rec.spans] == ["phase.outer"] and rec.counters == {"n": 2}
    assert "phase.outer" in _annotations(tmp_path / "inside.json.gz")


def test_trace_writes_the_spans_as_user_annotations(tmp_path):
    with profiling.trace(str(tmp_path), name="spans"):
        with profiling.span("phase.outer"):
            with profiling.span("phase.inner"):
                torch.ones(8).sum()
    assert profiling.span("after") is profiling.span("trace")  # its recording closed
    marked = _annotations(tmp_path / "spans.json.gz")
    assert {"phase.outer", "phase.inner"} <= set(marked)
    outer, inner = marked["phase.outer"], marked["phase.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= \
        outer["ts"] + outer["dur"]
    s = profiling.trace_summary(str(tmp_path / "spans.json.gz"), window="phase.inner")
    assert s["wall_us"] > 0


def test_wavlm_runtime_records_its_phases_inside_encode():
    from wavjepa_tpu_torch.api.runtime import RuntimeWavLM
    from wavjepa_tpu_torch.models.wavlm import WavLMConfig

    cfg = WavLMConfig(conv_dim=(16,) * 7, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128, dtype=torch.float32)
    runtime = RuntimeWavLM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(400 + 320 * n).astype(np.float32) for n in (30, 11)]
    with profiling.recording() as rec:
        runtime.get_scene_embeddings(waves)
    by_id = {s.id: s for s in rec.spans}
    (root,) = [s for s in rec.spans if s.name == "embed.request"]
    assert [s.name for s in rec.spans if s.parent == root.id] == [
        "embed.prepare", "embed.h2d", "embed.encode"]
    (encode,) = [s for s in rec.spans if s.name == "embed.encode"]
    inner = [s.name for s in rec.spans if s.parent == encode.id]
    assert inner == ["wavlm.frontend", "wavlm.pos_conv", "wavlm.encoder"]
    assert all(by_id[s.parent] is encode for s in rec.spans if s.name.startswith("wavlm."))
    # the projection's norm and layer 0's first, then two joins a layer
    assert rec.counters == {"embed.tokens": 62, "embed.padded_tokens": 19,
                            "layer_norm.plain": 2 + 2 * 2}


def _all_reduce_stub(params, *scalars, group=None):
    """The gradient round at world size 2 with the other rank's gradients
    equal to this one's: every sum doubles."""
    for p in params:
        if p.grad is not None:
            p.grad.mul_(2)
    return tuple(2 * s for s in scalars)


def test_step_records_the_all_reduce_only_across_ranks(monkeypatch):
    from wavjepa_tpu_torch.train import step as step_module

    cfg = JEPAConfig(**TINY)
    state, step = _state(cfg), _step(False, accum=1)
    crops, *masks = step.prepare(cfg, _clips(), torch.Generator().manual_seed(0))
    with profiling.recording() as alone:
        step.step_on(state, crops, *masks)
    assert "train.all_reduce" not in [s.name for s in alone.spans]
    monkeypatch.setattr(step_module, "data_group", lambda: (0, 2))
    monkeypatch.setattr(step_module, "all_reduce_gradients", _all_reduce_stub)
    with profiling.recording() as rec:
        step.step_on(state, crops, *masks)
    names = [s.name for s in rec.spans]
    assert names.count("train.all_reduce") == 1
    assert names.index("train.backward") < names.index("train.all_reduce") < names.index(
        "train.update")
    (ar,) = [s for s in rec.spans if s.name == "train.all_reduce"]
    assert ar.parent is None  # step_on alone: no train.step around it


def test_denoise_step_records_the_all_reduce_across_ranks(monkeypatch):
    from wavjepa_tpu_torch.models.denoiser import DenoiserConfig, DenoiserStudent
    from wavjepa_tpu_torch.train import denoise_step as D

    cfg = JEPAConfig(**{k: v for k, v in TINY.items() if k != "size"}, encoder_layers=2,
                     encoder_dim=32, encoder_heads=4, decoder_layers=1, decoder_dim=16,
                     decoder_heads=4)
    teacher = JEPA(cfg)
    teacher.init_parameters(torch.Generator().manual_seed(1))
    teacher.requires_grad_(False)
    student = DenoiserStudent(cfg)
    student.init_parameters(torch.Generator().manual_seed(2))
    opt = D.DenoiseOptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = D.DenoiseTrainState(student, D.make_denoise_optimizer(opt, student))
    step = D.make_denoise_train_step(opt, DenoiserConfig(jepa=cfg, original_sr=3200,
                                                         nr_samples_per_audio=2,
                                                         target_seconds=1.0),
                                     with_rir=False, with_noise=False)
    rng = np.random.default_rng(3)
    clean, noisy = (torch.from_numpy(rng.standard_normal((4, 1, cfg.target_length)).astype(
        np.float32)) for _ in range(2))
    monkeypatch.setattr(D, "data_group", lambda: (0, 2))
    monkeypatch.setattr(D, "all_reduce_gradients", _all_reduce_stub)
    with profiling.recording() as rec:
        step.step_on(state, teacher, clean, noisy)
    assert [s.name for s in rec.spans].count("train.all_reduce") == 1
