"""Denoise distillation: the teacher, the warm-started student, the step
loop; and the scene batches that it and WavJEPA-Nat train on.

Counterpart of ``wavjepa_tpu/train/denoise_loop.py``. ``train_denoiser``
loads the teacher (``load_teacher``: the student weights of a JEPA
checkpoint, frozen), copies its encoder path into the student, and runs the
denoise step (``train/denoise_step.py``) over scene batches in
``train/loop.run_loop``, the loop that ``train_jepa`` runs: a bank refresh
is written after the step that consumed its batch, and throughput counts
clips and crops apart. Checkpoints (the student alone, under the
reference's names, which the HEAR runtime serves) go to
``<save_dir>/Denoise-<run identity>/ckpt`` every ``min(trainer.ckpt_every,
2500)`` steps; a run resumes from the newest.

The batch builders (``synthetic_denoise_batches``,
``effective_scene_flags``, ``build_denoise_data_iterator``) take the scene
length and the RIR length from the scene rate (``NatSceneConfig``, 32 kHz),
the run's ``data.target_seconds`` (10 s) and 2-s RIRs.

Under torchrun both runs are data-parallel as ``train/loop.py`` says: every
rank loads the teacher, the student starts from rank 0's, and each rank is
given its rows of the global synthetic batch or batches its share from its
own shards, with a scene bank of its own.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from wavjepa_tpu_torch.api.convert import load_torch_checkpoint, unwrap_state_dict
from wavjepa_tpu_torch.api.runtime import DeviceLike, resolve_device
from wavjepa_tpu_torch.data.pipeline import ShardBatches, process_group, rank_batch_size
from wavjepa_tpu_torch.models.denoiser import DenoiserConfig, student_from_jepa
from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE, JEPA, JEPAConfig
from wavjepa_tpu_torch.train.config import Config
from wavjepa_tpu_torch.train.denoise_step import (
    DenoiseOptimizerConfig,
    DenoiseTrainState,
    make_denoise_optimizer,
    make_denoise_train_step,
)
from wavjepa_tpu_torch.parallel.mesh import replicated, shard_batch
from wavjepa_tpu_torch.train.loop import join_run, open_run, run_loop
from wavjepa_tpu_torch.train.state import TEACHER_PREFIX
from wavjepa_tpu_torch.train.step import NatSceneConfig

RIR_SECONDS = 2.0


def synthetic_denoise_batches(
    batch_size: int,
    scene_len: int,
    rir_len: int,
    max_noise: int = 5,
    with_rir: bool = True,
    with_noise: bool = True,
    n_channels: int = 1,
    seed: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Random scene batches, as the JAX package draws them: white clips, a
    unit impulse plus a short random tail a channel for the source's RIR,
    white noise over the whole clip at an SNR in [−5, 5] dB, and
    ``max_noise`` noise sources whose RIRs are unit impulses."""
    rng = np.random.default_rng(seed)
    c = n_channels
    while True:
        batch = {"audio": rng.standard_normal((batch_size, scene_len)).astype(np.float32)}
        if with_rir:
            rir = np.zeros((batch_size, c, rir_len), np.float32)
            rir[:, :, 0] = 1.0
            rir[:, :, 1:200] = 0.05 * rng.standard_normal((batch_size, c, 199))
            batch["source_rir"] = rir
        if with_noise:
            batch["noise"] = rng.standard_normal((batch_size, scene_len)).astype(np.float32)
            batch["noise_start"] = np.zeros((batch_size,), np.int32)
            batch["noise_length"] = np.full((batch_size,), scene_len, np.int32)
            batch["snr"] = rng.uniform(-5, 5, (batch_size,)).astype(np.float32)
            if with_rir:
                nr = np.zeros((batch_size, max_noise, c, rir_len), np.float32)
                nr[:, :, :, 0] = 1.0
                batch["noise_rirs"] = nr
        yield batch


def effective_scene_flags(cfg: Config) -> tuple[bool, bool]:
    """(with_rir, with_noise) that the batches carry: a shard-fed run has
    RIRs and noise only where ``data.rir_dir`` and ``data.noise_dir`` are
    set; synthetic batches have whatever the flags ask."""
    synthetic = cfg.data.synthetic or not cfg.data.data_dirs
    with_rir = cfg.data.with_rir and (synthetic or bool(cfg.data.rir_dir))
    with_noise = cfg.data.with_noise and (synthetic or bool(cfg.data.noise_dir))
    return with_rir, with_noise


def build_denoise_data_iterator(cfg: Config) -> Iterator[dict[str, np.ndarray]]:
    """Scene batches: synthetic ones when ``data.synthetic`` is set or
    ``data.data_dirs`` is empty; else the shard pipeline, started, as a
    ``ShardBatches`` whose ``stop()`` stops its workers and whose
    ``.source.scene_bank()`` is the host bank (None unless
    ``data.rir_bank_size`` or ``data.noise_bank_size`` is above 0), which
    the train loop sends to the device once. The JAX package returns the
    bank beside the batches instead. A data-parallel rank is given its rows
    of each global synthetic batch, or batches its share of
    ``trainer.batch_size`` from its own shards."""
    sr = NatSceneConfig().original_sr
    with_rir, with_noise = effective_scene_flags(cfg)
    if cfg.data.synthetic or not cfg.data.data_dirs:
        return map(shard_batch, synthetic_denoise_batches(
            cfg.trainer.batch_size,
            scene_len=int(sr * cfg.data.target_seconds),
            rir_len=int(sr * RIR_SECONDS),
            with_rir=with_rir,
            with_noise=with_noise,
            n_channels=cfg.data.in_channels if cfg.data.nat_scenes else 1,
            seed=cfg.trainer.seed,
        ))
    from wavjepa_tpu_torch.data.denoise_pipeline import DenoiseSampleSource, denoise_batches

    host_id, num_hosts = process_group()
    batch = rank_batch_size(cfg.trainer.batch_size, num_hosts)
    source = DenoiseSampleSource(
        cfg.data.data_dirs,
        rir_pattern=cfg.data.rir_dir if with_rir else None,
        noise_pattern=cfg.data.noise_dir if with_noise else None,
        sr=sr,
        target_seconds=cfg.data.target_seconds,
        snr_low=cfg.data.snr_low,
        snr_high=cfg.data.snr_high,
        rir_seconds=RIR_SECONDS,
        num_workers=cfg.data.num_workers,
        host_id=host_id,
        num_hosts=num_hosts,
        seed=cfg.trainer.seed,
        transfer_dtype=cfg.data.transfer_dtype,
        rir_bank_size=cfg.data.rir_bank_size if with_rir else 0,
        noise_bank_size=cfg.data.noise_bank_size if with_noise else 0,
    )
    batches = denoise_batches(source, batch,
                              refresh_rirs_per_batch=cfg.data.rir_refresh_per_batch)
    return ShardBatches(source, batches)


def load_teacher(ckpt_path: str, model_cfg: JEPAConfig, seed: int,
                 device: DeviceLike = None) -> JEPA:
    """The frozen teacher on ``device`` (``cuda`` unless the caller names
    another, raising with no CUDA device): a JEPA of ``model_cfg`` with the
    student weights of a port training checkpoint or a reference ``.ckpt``
    (its ``teacher_encoder.*`` EMA weights are dropped, as the JAX package
    takes the checkpoint's student); what the file lacks keeps its seeded
    initialisation, and with no path the whole teacher is seeded. It takes
    no gradient and is in no optimizer."""
    dev = resolve_device(device)
    teacher = JEPA(model_cfg)
    teacher.init_parameters(torch.Generator().manual_seed(seed))
    if ckpt_path:
        if Path(ckpt_path).is_dir():
            raise NotImplementedError("orbax checkpoint directories have no port yet")
        names = set(teacher.state_dict())
        sd = unwrap_state_dict(load_torch_checkpoint(ckpt_path))
        sd = {k: v for k, v in sd.items() if k in names and not k.startswith(TEACHER_PREFIX)}
        if not any(k.startswith(ENCODER_SIDE) for k in sd):
            raise KeyError(f"{ckpt_path} holds no JEPA encoder weights")
        teacher.load_state_dict(sd, strict=False)
    teacher.requires_grad_(False)
    return teacher.to(dev).eval()


def denoise_optimizer_config(cfg: Config) -> DenoiseOptimizerConfig:
    """The run's optimizer settings. The warmup and total steps default to
    min(5000, trainer.steps) and trainer.steps where the configuration has
    the SSL defaults (100k / 375k) and neither key was set explicitly, as in
    the JAX package."""
    o = cfg.optimizer
    ssl_defaults = (o.warmup_steps, o.total_steps) == (100_000, 375_000)

    def default(key):
        return ssl_defaults and key not in cfg.explicit_keys

    return DenoiseOptimizerConfig(
        lr=o.lr, b1=o.b1, b2=o.b2, eps=o.eps, weight_decay=o.weight_decay,
        grad_clip=o.grad_clip,
        warmup_steps=(min(5_000, cfg.trainer.steps) if default("optimizer.warmup_steps")
                      else o.warmup_steps),
        total_steps=cfg.trainer.steps if default("optimizer.total_steps") else o.total_steps,
    )


def build_denoise_run(cfg: Config, device: DeviceLike = None):
    """(device, model configuration, fresh DenoiseTrainState, step function)
    of a denoise run, as ``train_denoiser`` builds them before it restores a
    checkpoint. The step function is ``step_fn(state, batch, generator,
    rir_bank)``, the run's teacher (``load_teacher``) bound in. In a
    process group the teacher, and so the student, are rank 0's."""
    dev = join_run(cfg, device)
    model_cfg = cfg.build_denoise_model_config()  # raises on settings the port lacks
    teacher = replicated(load_teacher(cfg.teacher_ckpt, model_cfg, cfg.trainer.seed, dev))
    student = student_from_jepa(teacher)
    opt_cfg = denoise_optimizer_config(cfg)
    state = DenoiseTrainState(student, make_denoise_optimizer(opt_cfg, student))
    dcfg = DenoiserConfig(jepa=model_cfg, alpha=cfg.alpha,
                          original_sr=NatSceneConfig().original_sr,
                          nr_samples_per_audio=cfg.data.samples_per_audio,
                          target_seconds=cfg.data.target_seconds,
                          log_clean_loss=cfg.log_clean_loss)
    step = make_denoise_train_step(opt_cfg, dcfg, *effective_scene_flags(cfg),
                                   accum_steps=cfg.resolved_denoise_accum_steps())

    def step_fn(state, batch, generator, rir_bank=None):
        return step(state, teacher, batch, generator, rir_bank)

    return dev, model_cfg, state, step_fn


def train_denoiser(
    cfg: Config,
    data_iter: Optional[Iterator[dict]] = None,
    max_steps: Optional[int] = None,
    device: DeviceLike = None,
) -> DenoiseTrainState:
    """Run (or resume) denoise distillation on ``device`` (cuda unless told
    otherwise; raises without CUDA), as one rank of a data-parallel run when
    launched under torchrun. The teacher comes from
    ``cfg.teacher_ckpt`` (``load_teacher``), the student is its encoder
    path's copy. Without ``data_iter`` the batches come from
    ``build_denoise_data_iterator``, and a shard pipeline built here is
    stopped when the loop returns or raises. Returns the final state."""
    dev, model_cfg, state, step_fn = build_denoise_run(cfg, device)
    run_dir = Path(cfg.trainer.save_dir) / ("Denoise-" + cfg.run_identity())
    ckpt = open_run(run_dir, model_cfg, state, cfg, min(cfg.trainer.ckpt_every, 2_500))
    owned = None
    if data_iter is None:
        data_iter = owned = build_denoise_data_iterator(cfg)
    total = max_steps if max_steps is not None else cfg.trainer.steps
    return run_loop(cfg, state, step_fn, data_iter, owned, run_dir, ckpt, total, dev)
