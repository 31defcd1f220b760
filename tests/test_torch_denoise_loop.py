"""Denoise distillation's configuration, teacher, loop and CLI in the port:
``build_denoise_model_config`` and ``resolved_denoise_accum_steps`` as the
JAX package resolves them over a grid of batches, crops and overrides; the
CLI's defaults as the JAX package's ``denoise.py`` applies them, yielding to
YAML and command-line keys; ``load_teacher`` from a port checkpoint equal
to the JAX package's ``load_teacher_params`` (the checkpoint's student, not
its EMA teacher); then ``train_denoiser`` and ``python -m
wavjepa_tpu_torch.denoise`` at tiny size on the CPU, from synthetic scene
batches and from shards with device banks, a checkpoint of the student
alone that ``load_model`` serves, and the resume."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import denoise as jax_denoise_cli
from tests.test_torch_nat_data import write_scene_shards
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import jepa_config_to_dict as jax_jepa_config_to_dict
from wavjepa_tpu.train import config as jcfg
from wavjepa_tpu.train import denoise_loop as jax_denoise_loop
from wavjepa_tpu_torch import denoise as cli
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.api.runtime import load_model
from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE, jepa_config_to_dict
from wavjepa_tpu_torch.train import config as tcfg
from wavjepa_tpu_torch.train.checkpoint import CheckpointManager, read_model_config
from wavjepa_tpu_torch.train.denoise_loop import (
    denoise_optimizer_config,
    load_teacher,
    train_denoiser,
)
from wavjepa_tpu_torch.train.loop import train_jepa

GRID = [
    [],
    ["trainer.batch_size=8", "data.samples_per_audio=16"],  # 128 crops: 4
    ["trainer.batch_size=5", "data.samples_per_audio=26"],  # 130: 2
    ["trainer.batch_size=9", "data.samples_per_audio=15"],  # 135: 1
    ["trainer.batch_size=3", "data.samples_per_audio=42"],  # 126: 1
    ["trainer.accum_steps=3", "trainer.batch_size=2"],
    ["trainer.batch_size=8", "data.samples_per_audio=16", "trainer.remat=true"],
    ["trainer.remat_encoder=true", "trainer.remat_conv=false", "trainer.precision=f32",
     "trainer.attn_impl=fused_block", "trainer.attn_impl_decoder=einsum", "trainer.size=large"],
]

# the tiny model at tests/test_denoiser.py's rates: 31 tokens a crop, 1-s scenes
TINY_RUN = [
    "data.synthetic=true", "trainer.size=tiny", "trainer.batch_size=2",
    "data.samples_per_audio=2", "data.sr=1600", "data.process_seconds=0.201",
    "data.target_seconds=1.0", "extractor.conv_spec=[[16,10,5],[16,3,2]]",
    "trainer.average_top_k_layers=2", "trainer.precision=f32", "trainer.log_every=1",
]


@pytest.mark.parametrize("overrides", GRID)
def test_denoise_model_config_resolves_as_the_jax_package(overrides):
    t = tcfg.apply_overrides(tcfg.Config(), list(overrides))
    j = jcfg.apply_overrides(jcfg.load_config(None), list(overrides))
    assert t.resolved_denoise_accum_steps() == j.resolved_denoise_accum_steps()
    td = jepa_config_to_dict(t.build_denoise_model_config())
    assert td == jax_jepa_config_to_dict(j.build_denoise_model_config())
    assert td["pack_encoder"] is None and td["pack_decoder"] is None


def test_denoise_model_config_refuses_multi_device_settings():
    cfg = tcfg.apply_overrides(tcfg.Config(), ["trainer.num_devices=2"])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        cfg.build_denoise_model_config()  # no process group of two
    cfg = tcfg.apply_overrides(tcfg.Config(), ["trainer.model_parallel=2"])
    with pytest.raises(ValueError, match="trainer.model_parallel=2 does not divide the 1 rank"):
        cfg.build_denoise_model_config()  # no tensor-parallel group of two


def _jax_cli_config(argv, monkeypatch):
    seen = {}
    monkeypatch.setattr(jax_denoise_loop, "train_denoiser", lambda cfg: seen.setdefault("cfg", cfg))
    jax_denoise_cli.main(list(argv))
    return seen["cfg"]


@pytest.mark.parametrize("argv", [
    [],
    ["optimizer.lr=3e-4", "trainer.steps=200"],
    ["YAML", "trainer.batch_size=2"],
    ["optimizer.warmup_steps=7", "optimizer.grad_clip=2.5", "data.samples_per_audio=4"],
])
def test_cli_defaults_yield_to_yaml_and_cli_keys_as_in_the_jax_package(argv, tmp_path,
                                                                        monkeypatch):
    if argv and argv[0] == "YAML":
        path = tmp_path / "run.yaml"
        path.write_text("optimizer:\n  weight_decay: 0.01\ndata:\n  samples_per_audio: 4\n"
                        "trainer:\n  steps: 3000\n")
        argv = [str(path), *argv[1:]]
    cfg = cli.denoise_config(argv)
    ref = _jax_cli_config(argv, monkeypatch)
    assert tcfg.config_to_dict(cfg) == jcfg.config_to_dict(ref)
    assert cfg.model == "Denoiser"
    opt = denoise_optimizer_config(cfg)
    assert (opt.warmup_steps, opt.total_steps) == (ref.optimizer.warmup_steps,
                                                   ref.optimizer.total_steps)


def test_optimizer_defaults_of_a_run_built_in_code():
    cfg = tcfg.apply_overrides(tcfg.Config(), ["trainer.steps=40"])
    opt = denoise_optimizer_config(cfg)  # the SSL defaults left as they are
    assert (opt.warmup_steps, opt.total_steps, opt.lr) == (40, 40, cfg.optimizer.lr)
    kept = tcfg.apply_overrides(tcfg.Config(), ["optimizer.warmup_steps=100000"])
    assert denoise_optimizer_config(kept).warmup_steps == 100_000


def _jepa_checkpoint(tmp_path):
    cfg = tcfg.apply_overrides(tcfg.Config(), [*TINY_RUN, "optimizer.warmup_steps=1",
                                               f"trainer.save_dir={tmp_path / 'ssl'}"])
    train_jepa(cfg, max_steps=1, device="cpu")
    run = Path(cfg.trainer.save_dir) / cfg.run_identity()
    return cfg, str(run / "ckpt" / "step_00000001.ckpt")


def test_load_teacher_takes_the_checkpoints_student_as_the_jax_package(tmp_path):
    cfg, path = _jepa_checkpoint(tmp_path)
    model_cfg = cfg.build_denoise_model_config()
    teacher = load_teacher(path, model_cfg, seed=5, device="cpu")
    sd = torch.load(path, weights_only=False)["state_dict"]
    got = teacher.state_dict()
    for k, v in got.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    # the EMA teacher moved apart from the student in the step
    assert any(not torch.equal(got[f"encoder.{k}"], sd[f"teacher_encoder.{k}"])
               for k in teacher.encoder.state_dict())
    assert not any(p.requires_grad for p in teacher.parameters())

    j = jcfg.apply_overrides(jcfg.load_config(None), list(TINY_RUN))
    jparams = jax_denoise_loop.load_teacher_params(path, JaxJEPA(j.build_denoise_model_config()))
    want = state_dict_from_jax_params(jparams)
    assert set(want) == set(got)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_load_teacher_seeds_what_the_file_lacks_and_refuses_a_foreign_file(tmp_path):
    cfg, _ = _jepa_checkpoint(tmp_path)
    model_cfg = cfg.build_denoise_model_config()
    seeded = load_teacher("", model_cfg, seed=5, device="cpu").state_dict()
    encoder_only = {k: torch.randn_like(v) for k, v in seeded.items()
                    if k.startswith(ENCODER_SIDE)}
    torch.save({"state_dict": encoder_only}, tmp_path / "enc.ckpt")
    teacher = load_teacher(str(tmp_path / "enc.ckpt"), model_cfg, seed=5, device="cpu").state_dict()
    for k, v in teacher.items():
        torch.testing.assert_close(v, encoder_only.get(k, seeded[k]), rtol=0, atol=0, msg=k)
    torch.save({"state_dict": {"head.weight": torch.zeros(2)}}, tmp_path / "other.ckpt")
    with pytest.raises(KeyError, match="no JEPA encoder weights"):
        load_teacher(str(tmp_path / "other.ckpt"), model_cfg, seed=5, device="cpu")


def _run_dir(cfg):
    return Path(cfg.trainer.save_dir) / ("Denoise-" + cfg.run_identity())


def _metrics(cfg):
    return [json.loads(x) for x in (_run_dir(cfg) / "logs" / "metrics.jsonl").read_text()
            .splitlines()]


def test_cli_trains_checkpoints_and_its_student_serves(tmp_path, capsys):
    _, teacher_path = _jepa_checkpoint(tmp_path)
    argv = [*TINY_RUN, "trainer.steps=2", f"teacher_ckpt={teacher_path}",
            f"trainer.save_dir={tmp_path / 'dn'}"]
    cli.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = cli.denoise_config(argv)
    assert f"run: Denoise-{cfg.run_identity()}" in out and "[step 2] loss=" in out
    lines = _metrics(cfg)
    assert [x["step"] for x in lines] == [1, 2]
    # warm-started: the student is the teacher's encoder path at step 1
    assert lines[0]["loss_clean"] < 1e-10 and lines[0]["loss"] > 0
    assert all(np.isfinite(x["loss"]) and x["data_wait_ms"] >= 0 for x in lines)
    assert lines[1]["crops_per_sec"] == pytest.approx(2 * lines[1]["clips_per_sec"])
    ckpt = _run_dir(cfg) / "ckpt" / "step_00000002.ckpt"
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    assert sd and all(k.startswith(ENCODER_SIDE) for k in sd)
    assert read_model_config(_run_dir(cfg)) == cfg.build_denoise_model_config()

    rt = load_model(str(ckpt), device="cpu")
    assert rt.config.dtype == torch.bfloat16 and rt.config.encoder_dim == 32
    for name, v in rt.model.state_dict().items():
        if name in sd:
            torch.testing.assert_close(v, sd[name], rtol=0, atol=0)
    rng = np.random.default_rng(0)
    emb = rt.get_scene_embeddings([rng.standard_normal(n).astype(np.float32)
                                   for n in (500, 900)])
    assert emb.shape == (2, 32) and torch.isfinite(emb).all()


def test_train_denoiser_resumes_from_its_newest_checkpoint(tmp_path, capsys):
    cfg = tcfg.apply_overrides(tcfg.Config(), [*TINY_RUN, "trainer.ckpt_every=1",
                                               f"trainer.save_dir={tmp_path}"])
    first = train_denoiser(cfg, max_steps=1, device="cpu")
    saved = {k: v.clone() for k, v in first.student.state_dict().items()}
    state = train_denoiser(cfg, max_steps=2, device="cpu")
    assert "resumed from step 1" in capsys.readouterr().out
    assert state.step == 2
    assert CheckpointManager(_run_dir(cfg) / "ckpt").steps() == [1, 2]
    blob = torch.load(_run_dir(cfg) / "ckpt" / "step_00000001.ckpt", weights_only=False)
    for k, v in saved.items():
        torch.testing.assert_close(blob["state_dict"][k], v, rtol=0, atol=0)
    assert blob["optimizer"]["state"]  # the AdamW moments went with it


def test_train_denoiser_from_shards_with_device_banks(tmp_path):
    audio, rir, noise = write_scene_shards(tmp_path / "shards", sr=32000, clip_s=0.2)
    cfg = tcfg.apply_overrides(tcfg.Config(), [
        "trainer.size=tiny", "trainer.batch_size=2", "data.samples_per_audio=2",
        "data.process_seconds=0.201", "data.target_seconds=0.4", "trainer.log_every=1",
        f"data.data_dirs={audio}", f"data.rir_dir={rir}", f"data.noise_dir={noise}",
        "data.num_workers=0", "data.rir_bank_size=3", "data.noise_bank_size=2",
        "data.rir_refresh_per_batch=1", f"trainer.save_dir={tmp_path / 'run'}"])
    state = train_denoiser(cfg, max_steps=3, device="cpu")
    assert state.step == 3
    assert all(np.isfinite(x["loss"]) for x in _metrics(cfg))
    assert all(torch.isfinite(p).all() for p in state.student.parameters())


def test_denoise_entry_points_raise_without_cuda_or_on_several_devices(tmp_path, monkeypatch):
    def cfg(*extra):
        return tcfg.apply_overrides(tcfg.Config(), [*TINY_RUN, f"trainer.save_dir={tmp_path}",
                                                    *extra])

    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        train_denoiser(cfg("trainer.model_parallel=2"), device="cpu")
    assert not any(tmp_path.iterdir())  # refused before any run directory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_denoiser(cfg(), max_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([*TINY_RUN, f"trainer.save_dir={tmp_path}"])
