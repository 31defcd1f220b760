"""The denoise-distillation train step.

Counterpart of ``wavjepa_tpu/train/denoise_step.py``. One call takes a
scene batch through the whole step on the device:

  clean clips at ``original_sr`` with their RIRs, noise and SNRs (inline,
  or indices into a device bank) → mono scenes (the source RIR's first
  channel, ``build_scenes``) → both views resampled to the model's rate →
  n random crops a clip, at the same offsets in both views → per-crop
  instance norm → compute dtype → the frozen teacher's ``represent`` on the
  clean crops (no gradient) → the student on the clean and the noisy crops
  → α-blended MSE (one pass, or the mean of equal microbatch means) → clip
  by global norm → AdamW at the learning rate of the step before the
  increment → step + 1.

At α = 0 the clean view's gradient is exactly zero, and at α = 1 the noisy
view's: that view's student forward runs under ``torch.no_grad()``, which
keeps no activations and leaves the gradients equal to the undetached
loss's. At α = 0 with ``log_clean_loss`` off, the clean forward does not
run, and ``loss_clean`` is 0.

``DenoiseTrainStep.step_on`` runs the step from given crops: torch cannot
reproduce ``jax.random``, so the tests feed both packages the same crops.

In a torch.distributed process group each rank is given its rows of the
global scene batch, draws the crop starts for the global batch and takes
its rows (as ``train/step.py``), and sums its gradients and loss terms with
the other ranks' once a step (span ``train.all_reduce``); divided by the
world size they are the mean of the ranks' equal microbatch means, the JAX
package's global mean.

Under tensor parallelism the student is a rank's shard, its gradients are
summed over the data-parallel group alone and their norm is the whole
model's (as ``train/step.py``). The frozen teacher stays whole on every
rank: it takes no gradient, so its copy costs only memory and a forward
that every rank of the group repeats.
"""

from __future__ import annotations

import dataclasses

import torch

from wavjepa_tpu_torch.models.denoiser import (
    DenoiserConfig,
    DenoiserStudent,
    denoiser_distillation_loss,
)
from wavjepa_tpu_torch.models.jepa import JEPA
from wavjepa_tpu_torch.ops.audio import crops_at, instance_normalize, random_starts, wire_to_f32
from wavjepa_tpu_torch.ops.resample import resample_torch
from wavjepa_tpu_torch.utils.profiling import span
from wavjepa_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    data_group,
    data_process_group,
    gather_params,
    gather_train_state,
    shard_batch,
    shard_train_state,
)
from wavjepa_tpu_torch.train.schedule import warmup_cosine_schedule
from wavjepa_tpu_torch.train.step import (
    NatSceneConfig,
    build_scenes,
    make_optimizer,
    optimizer_update,
    split_leaves,
)
from wavjepa_tpu_torch.train.state import param_names


@dataclasses.dataclass(frozen=True)
class DenoiseOptimizerConfig:
    """configs/optimizer/adamW_denoise.yaml and the denoise trainer flags."""

    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 5_000
    total_steps: int = 100_000


@dataclasses.dataclass
class DenoiseTrainState:
    """The student, its optimizer and the step counter; the teacher is an
    argument of the step, frozen, and not part of the state."""

    student: DenoiserStudent
    optimizer: torch.optim.Optimizer
    step: int = 0

    def weights(self) -> dict[str, torch.Tensor]:
        """The student's state_dict, whole: the encoder side of a JEPA
        checkpoint."""
        return gather_params(dict(self.student.state_dict()))

    def full_state(self) -> tuple[dict, dict]:
        """(``weights()``, the optimizer's ``state_dict`` with whole AdamW
        moments), as ``TrainState.full_state``."""
        return gather_train_state(dict(self.student.state_dict()), self.optimizer.state_dict(),
                                  param_names(self.student))

    def load_full_state(self, weights: dict, opt_state: dict) -> None:
        weights, opt_state = shard_train_state(weights, opt_state, param_names(self.student))
        self.student.load_state_dict(weights)
        self.optimizer.load_state_dict(opt_state)


def make_denoise_optimizer(cfg: DenoiseOptimizerConfig,
                           student: DenoiserStudent) -> torch.optim.AdamW:
    """AdamW over the student's parameters, as ``train/step.make_optimizer``
    builds it; the step sets its learning rate from the schedule."""
    return make_optimizer(cfg, student)


class DenoiseTrainStep:
    """``step(state, teacher, batch, generator, rir_bank=None) -> (state,
    metrics)``; see the module docstring for the order. ``state`` is
    updated in place and returned. ``metrics`` holds ``loss``,
    ``grad_norm`` (before clipping), ``loss_clean`` and
    ``loss_denoise_dereverb`` as device tensors and ``lr`` as a float."""

    def __init__(self, opt_cfg: DenoiseOptimizerConfig, cfg: DenoiserConfig,
                 with_rir: bool, with_noise: bool, accum_steps: int = 1):
        self.cfg = cfg
        self.scene_cfg = NatSceneConfig(with_rir=with_rir, with_noise=with_noise,
                                        n_channels=1, original_sr=cfg.original_sr)
        self.grad_clip = opt_cfg.grad_clip
        self.lr_schedule = warmup_cosine_schedule(opt_cfg.lr, opt_cfg.warmup_steps,
                                                  opt_cfg.total_steps)
        self.accum_steps = accum_steps

    def __call__(self, state: DenoiseTrainState, teacher: JEPA, batch: dict,
                 generator: torch.Generator, rir_bank=None):
        crops_clean, crops_noisy = self.prepare(batch, generator, rir_bank)
        return self.step_on(state, teacher, crops_clean, crops_noisy)

    def prepare(self, batch: dict, generator: torch.Generator, rir_bank=None):
        """A scene batch (this rank's rows of the global batch) → (clean
        crops, noisy crops), each (B·n, 1, crop) in the compute dtype, cut at
        the same offsets, drawn from ``generator`` for the global batch."""
        jcfg = self.cfg.jepa
        noisy = build_scenes(self.scene_cfg, jcfg.sample_rate, batch, rir_bank)
        clean = wire_to_f32(batch["audio"])[:, None, :]
        if self.cfg.original_sr != jcfg.sample_rate:
            clean = resample_torch(clean, self.cfg.original_sr, jcfg.sample_rate)
        _, world = data_group()
        starts = shard_batch(random_starts(generator, noisy, jcfg.target_length,
                                           self.cfg.nr_samples_per_audio,
                                           n_clips=noisy.shape[0] * world))
        views = []
        for audio in (clean, noisy):
            crops = instance_normalize(crops_at(audio, starts, jcfg.target_length))
            b, s, c, length = crops.shape
            views.append(crops.reshape(b * s, c, length).to(jcfg.dtype))
        return views

    def loss_fn(self, student: DenoiserStudent, teacher: JEPA, clean: torch.Tensor,
                noisy: torch.Tensor):
        """The α-blended loss of one (micro)batch: the teacher and a dead
        view's student forward without a gradient."""
        alpha = float(self.cfg.alpha)
        with torch.no_grad():
            targets = teacher.represent(clean)

        def view(x, live):
            if live:
                return student(x)
            with torch.no_grad():
                return student(x)

        clean_fwd = self.cfg.log_clean_loss or alpha != 0.0
        out_clean = view(clean, alpha != 0.0) if clean_fwd else None
        out_noisy = view(noisy, alpha != 1.0)
        return denoiser_distillation_loss(out_clean, out_noisy, targets, alpha)

    def step_on(self, state: DenoiseTrainState, teacher: JEPA, crops_clean: torch.Tensor,
                crops_noisy: torch.Tensor):
        student = state.student
        params = list(student.parameters())
        for p in params:
            p.grad = None
        a = self.accum_steps
        n_rows = crops_noisy.shape[0]
        if n_rows % a:
            raise ValueError(f"crop batch {n_rows} not divisible by accum_steps={a}")
        mb = n_rows // a
        loss = 0.0
        parts: dict = {}
        for i in range(a):  # the gradients sum over microbatches
            part = slice(i * mb, (i + 1) * mb)
            l_mb, p_mb = self.loss_fn(student, teacher, crops_clean[part], crops_noisy[part])
            l_mb.backward()
            loss = loss + l_mb.detach()
            parts = {k: parts.get(k, 0.0) + v.detach() for k, v in p_mb.items()}
        n_means, world = a, data_group()[1]
        if world > 1:  # every rank's microbatch means
            with span("train.all_reduce"):
                loss, *sums = all_reduce_gradients(params, loss, *parts.values(),
                                                   group=data_process_group())
            parts = dict(zip(parts, sums))
            n_means *= world
        if n_means > 1:  # the mean of equal microbatch means, as the JAX package
            inv = 1.0 / n_means
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}
        lr = self.lr_schedule(state.step)
        g_norm = optimizer_update(params, state.optimizer, lr, self.grad_clip,
                                  split_leaves(student))
        state.step += 1
        return state, {"loss": loss, "lr": lr, "grad_norm": g_norm, **parts}


def make_denoise_train_step(opt_cfg: DenoiseOptimizerConfig, cfg: DenoiserConfig,
                            with_rir: bool, with_noise: bool,
                            accum_steps: int = 1) -> DenoiseTrainStep:
    """The denoise step of a run; ``with_rir``/``with_noise`` say what its
    batches carry, ``accum_steps > 1`` splits the crop batch into that many
    equal microbatches."""
    return DenoiseTrainStep(opt_cfg, cfg, with_rir, with_noise, accum_steps)
