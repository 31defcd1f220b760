"""The port's training loop, checkpoints and CLI on the CPU at a tiny
configuration: a run end to end, from synthetic clips and from tar shards
written to a temporary directory, resume equivalence, the shard pipeline's
workers stopped however the loop ends, multi-device settings refused, and a
port checkpoint served by the HEAR runtimes of both packages (embeddings
f32, atol 5e-5, rtol 1e-4, as tests/test_torch_runtime.py)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.train.checkpoint import read_model_config as jax_read_model_config
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.models.jepa import JEPA
from tests.test_torch_data import write_audio_shards
from wavjepa_tpu_torch.train import __main__ as cli
from wavjepa_tpu_torch.train import loop
from wavjepa_tpu_torch.train.checkpoint import CheckpointManager, read_model_config
from wavjepa_tpu_torch.train.config import Config, apply_overrides
from wavjepa_tpu_torch.train.loop import build_data_iterator, prefetch_to_device, train_jepa
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import OptimizerConfig, make_optimizer

# 31 tokens a crop, a two-block frontend, the tiny encoder and predictor
TINY_RUN = [
    "data.synthetic=true", "trainer.size=tiny", "trainer.batch_size=2",
    "data.samples_per_audio=2", "data.sr=1600", "data.process_seconds=0.201",
    "data.target_seconds=1.0", "extractor.conv_spec=[[16,10,5],[16,3,2]]",
    "trainer.average_top_k_layers=2", "trainer.precision=f32", "trainer.log_every=1",
    "optimizer.warmup_steps=1",
]


def _cfg(save_dir, *extra):
    return apply_overrides(Config(), [*TINY_RUN, f"trainer.save_dir={save_dir}", *extra])


def _run_dir(cfg):
    from pathlib import Path

    return Path(cfg.trainer.save_dir) / cfg.run_identity()


def test_train_jepa_runs_on_the_cpu(tmp_path):
    cfg = _cfg(tmp_path)
    state = train_jepa(cfg, max_steps=2, device="cpu")
    assert state.step == 2
    run = _run_dir(cfg)
    lines = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
    # clips and crops counted apart: 2 crops a clip
    assert lines[1]["crops_per_sec"] == pytest.approx(2 * lines[1]["clips_per_sec"])
    assert (run / "ckpt" / "step_00000002.ckpt").is_file()
    assert read_model_config(run) == cfg.build_model_config()


def _params(state):
    out = {k: v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v.clone() for k, v in state.teacher_encoder.state_dict().items()})
    return out


def test_resume_equals_an_uninterrupted_run(tmp_path):
    straight = _params(train_jepa(_cfg(tmp_path / "a"), max_steps=3, device="cpu"))
    cfg = _cfg(tmp_path / "b")
    train_jepa(cfg, max_steps=1, device="cpu")
    resumed = train_jepa(cfg, max_steps=3, device="cpu")  # restores step 1, takes 2 more
    assert resumed.step == 3
    for k, v in straight.items():
        torch.testing.assert_close(_params(resumed)[k], v, atol=1e-7, rtol=0, msg=k)
    assert CheckpointManager(_run_dir(cfg) / "ckpt").steps() == [1, 3]


def test_a_port_checkpoint_serves_in_both_packages(tmp_path):
    cfg = _cfg(tmp_path)
    train_jepa(cfg, max_steps=1, device="cpu")
    run = _run_dir(cfg)
    ckpt = str(run / "ckpt" / "step_00000001.ckpt")
    # the architecture from model_config.json, served in bf16 as the JAX
    # package serves a sidecar; both packages compared in the run's f32
    served = trt.load_model(ckpt, device="cpu")
    assert served.config == dataclasses.replace(cfg.build_model_config(), dtype=torch.bfloat16)
    port = trt.load_model(ckpt, config=read_model_config(run), device="cpu")
    jax_rt = jrt.load_model(ckpt, config=jax_read_model_config(run))
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal(n).astype(np.float32) for n in (200, 700)]
    ref, _ = jax_rt.get_timestamp_embeddings(clips)
    out, _ = port.get_timestamp_embeddings(clips)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-4)


def test_checkpoint_keep_and_every(tmp_path):
    model = JEPA(_cfg(tmp_path).build_model_config())
    model.init_parameters(torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer(OptimizerConfig(), model))
    mgr = CheckpointManager(tmp_path / "ck", keep=2, every=2)
    assert mgr.latest_step() is None
    assert [mgr.save(s, state) for s in (1, 2, 3, 4, 6)] == [False, True, False, True, True]
    assert mgr.steps() == [4, 6]
    assert mgr.save(7, state, force=True) and mgr.steps() == [6, 7]
    blob = torch.load(mgr.path(7), weights_only=False)
    assert any(k.startswith("teacher_encoder.") for k in blob["state_dict"])
    assert not any(k.startswith("teacher.") for k in blob["state_dict"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def test_cli_trains_on_the_cpu_when_asked(tmp_path, capsys):
    cli.main([*TINY_RUN, "trainer.steps=1", f"trainer.save_dir={tmp_path}", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "run: Data=AudioSet" in out and "[step 1] loss=" in out


def test_training_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_jepa(_cfg(tmp_path), max_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([*TINY_RUN, f"trainer.save_dir={tmp_path}"])


def test_data_iterator_and_prefetch(tmp_path):
    cfg = _cfg(tmp_path)
    batches = build_data_iterator(cfg, start_step=3)
    first = next(batches)
    assert first.shape == (2, 1, 1600) and first.dtype == np.float32
    # batch i is a function of (seed, i): the resumed stream repeats it
    again = build_data_iterator(cfg, start_step=2)
    next(again)
    np.testing.assert_array_equal(next(again), first)
    fed = prefetch_to_device(iter([first, first * 2]), torch.device("cpu"))
    got = list(fed)
    assert len(got) == 2 and torch.equal(got[1], torch.from_numpy(first * 2))
    # data.data_dirs: the shard pipeline, whose worker reports a pattern
    # that matches no readable shard
    shard_batches = build_data_iterator(apply_overrides(_cfg(tmp_path), [
        "data.synthetic=false", f"data.data_dirs={tmp_path}/x-{{0..1}}.tar",
        "data.num_workers=0"]))
    try:
        with pytest.raises(RuntimeError, match="no readable sample"):
            next(shard_batches)
    finally:
        shard_batches.stop()
    # data.nat_scenes: scene batches (clean clips, RIRs, noise) for the step
    scenes = next(build_data_iterator(apply_overrides(_cfg(tmp_path), [
        "data.nat_scenes=true", "data.in_channels=2"])))
    assert set(scenes) == {"audio", "source_rir", "noise", "noise_rirs", "noise_start",
                           "noise_length", "snr"}
    assert scenes["audio"].shape == (2, 32000) and scenes["source_rir"].shape[:2] == (2, 2)


def test_prefetch_passes_on_a_source_error():
    def source():
        yield np.zeros((1, 1, 4), np.float32)
        raise OSError("disk")

    fed = prefetch_to_device(source(), torch.device("cpu"))
    next(fed)
    with pytest.raises(OSError, match="disk"):
        next(fed)


def _shard_cfg(tmp_path, *extra):
    """The tiny run from shards of 44.1k stereo, 3.2k and 1.6k mono clips,
    loaded in-process (num_workers=0)."""
    _, pattern = write_audio_shards(tmp_path / "shards", 2, 3,
                                    [(44100, 2), (3200, 1), (1600, 1)], 0.8)
    return _cfg(tmp_path / "run", "data.synthetic=false", f"data.data_dirs={pattern}",
                "data.num_workers=0", "data.shuffle_buffer=4", *extra)


def test_train_jepa_trains_from_shards(tmp_path):
    (tmp_path / "shards").mkdir()
    cfg = _shard_cfg(tmp_path)
    state = train_jepa(cfg, max_steps=2, device="cpu")
    assert state.step == 2
    run = _run_dir(cfg)
    lines = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) and x["data_wait_ms"] >= 0 for x in lines)
    assert (run / "ckpt" / "step_00000002.ckpt").is_file()


def test_cli_trains_from_shards(tmp_path, capsys):
    (tmp_path / "shards").mkdir()
    cfg = _shard_cfg(tmp_path)
    cli.main([*TINY_RUN, "data.synthetic=false", f"data.data_dirs={cfg.data.data_dirs}",
              "data.num_workers=0", "data.shuffle_buffer=4", "trainer.steps=2",
              f"trainer.save_dir={tmp_path / 'cli'}", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[step 2] loss=" in out
    assert (_run_dir(_cfg(tmp_path / "cli")) / "ckpt" / "step_00000002.ckpt").is_file()


def test_the_shard_source_stops_when_the_loop_returns_or_raises(tmp_path, monkeypatch):
    (tmp_path / "shards").mkdir()
    built = []

    def recording(cfg):
        built.append(loop.audio_shard_batches.__wrapped__(cfg))
        return built[-1]

    recording.__wrapped__ = loop.audio_shard_batches
    monkeypatch.setattr(loop, "audio_shard_batches", recording)
    train_jepa(_shard_cfg(tmp_path), max_steps=1, device="cpu")
    assert built[0].source.alive() == 0

    def failing_step(*args, **kwargs):
        def step(state, batch, generator, rir_bank=None):
            raise FloatingPointError("step failed")
        return step

    monkeypatch.setattr(loop, "make_jepa_train_step", failing_step)
    with pytest.raises(FloatingPointError, match="step failed"):
        train_jepa(_shard_cfg(tmp_path, f"trainer.save_dir={tmp_path / 'failing'}"),
                   max_steps=1, device="cpu")
    assert len(built) == 2 and built[1].source.alive() == 0


# two tensor-parallel ranks (or three) and two data-parallel ranks need a
# process group of as many, which a process not launched by torchrun does
# not join
REFUSED = {"trainer.model_parallel=2": (
               ValueError, "trainer.model_parallel=2 does not divide the 1 rank.s. of this run: "
                           "launch it with torchrun --nproc_per_node=2"),
           "trainer.model_parallel=3": (ValueError, "torchrun --nproc_per_node=3"),
           "trainer.num_devices=2": (RuntimeError, "torchrun --nproc_per_node=2")}


@pytest.mark.parametrize("setting", list(REFUSED))
def test_multi_device_settings_raise(tmp_path, setting):
    error, said = REFUSED[setting]
    cfg = _cfg(tmp_path, setting)
    with pytest.raises(error, match=said):
        cfg.build_model_config()
    with pytest.raises(error, match=said):
        train_jepa(cfg, max_steps=1, device="cpu")
    with pytest.raises(error, match=said):
        cli.main([*TINY_RUN, setting, f"trainer.save_dir={tmp_path}", "--device", "cpu"])
    assert not (tmp_path / "Data=AudioSet").exists()  # refused before any run directory


def test_all_visible_devices_train_on_one_and_say_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for setting, said in (("trainer.num_devices=0", True), ("trainer.num_devices=1", False)):
        train_jepa(_cfg(tmp_path / setting, setting), max_steps=1, device="cpu")
        out = capsys.readouterr().out
        assert ("2 CUDA devices are visible, and this process trains on one of them (cpu); "
                "launch it with torchrun --nproc_per_node=2 to train on all" in out) is said
