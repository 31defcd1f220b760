"""The JEPA train step.

Counterpart of ``wavjepa_tpu/train/step.py``. One call takes a batch of 10-s
clips through the whole step on the device:

  clips (or, for WavJEPA-Nat, scene batches: the clean clip, its RIRs and
  noise, gathered from the device bank where the batch carries indices →
  binaural or ambisonic scenes → resampled to the model's rate, see
  ``NatSceneConfig``) → wire format to f32 → n random 2.01-s crops a clip → per-crop
  instance norm → compute dtype → masks for the whole crop batch → packing
  canonicalisation → loss and gradients (one pass, or summed loss
  numerators over microbatches divided by the global target count) → clip
  by global norm as optax does → AdamW (weight decay on every parameter) at
  the learning rate of the step before the increment → EMA of the teacher
  from the student encoder before the update → step + 1.

Data parallelism (``parallel/mesh.py``): in a torch.distributed process
group each rank is given its rows of the global clip batch. The crop starts
and the masks are drawn for the global batch on every rank and each takes
its rows, so a rank's crops are those one process would cut from the same
clips. The loss numerators and target counts are summed over the ranks with
the gradients, in one all-reduce after the last microbatch, so the loss,
the gradients and their norm are the global ones and every rank takes the
same update. At world size 1, in a group or not, the step issues no
collective and is the one-process step.

Tensor parallelism (``trainer.model_parallel``, ``parallel/mesh.py``): the
ranks of one tensor-parallel group are one data-parallel replica. They take
the same rows, draw the same crops and masks, and hold shards of one model,
whose blocks sum their partial outputs over the group; the gradients are
summed over the data-parallel group alone, the replicated leaves' averaged
over the tensor-parallel group (equal but for the card's atomics), and the
global norm counts each split leaf's squared norm summed over the
tensor-parallel group once and each replicated leaf once
(``global_grad_norm``).

``JEPATrainStep.step_on`` runs the step from given crops and masks: torch
cannot reproduce ``jax.random``, so the tests feed both packages the same
crops and masks through it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from wavjepa_tpu_torch.ops.resample import resample_torch
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig, time_inverse_block_masks
from wavjepa_tpu_torch.models.jepa import JEPA, masked_prediction_loss
from wavjepa_tpu_torch.ops.audio import crops_at, instance_normalize, random_starts, wire_to_f32
from wavjepa_tpu_torch.ops.scenes import gather_scene_rirs, generate_scene, place_noise_from_bank
from wavjepa_tpu_torch.ops.transformer import TransformerEncoder
from wavjepa_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    data_group,
    data_process_group,
    global_grad_norm,
    mean_over_model_group,
    shard_batch,
    tp_rule,
)
from wavjepa_tpu_torch.train.schedule import ema_decay_schedule, warmup_cosine_schedule
from wavjepa_tpu_torch.train.state import TrainState, ema_update


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """configs/optimizer/adamW.yaml + Lightning trainer flags."""

    lr: float = 4e-4
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    weight_decay: float = 0.04
    grad_clip: float = 5.0
    warmup_steps: int = 100_000
    total_steps: int = 375_000


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    start_decay: float = 0.999
    end_decay: float = 0.99999
    anneal_end_step: int = 100_000


@dataclasses.dataclass(frozen=True)
class NatSceneConfig:
    """Scene synthesis in the step (``build_scenes``), for WavJEPA-Nat and
    the denoiser: the step takes dict batches of clean clips at
    ``original_sr`` with their RIRs, noise and SNRs (inline, or as indices
    into a device bank) and builds ``n_channels``-channel scenes (2
    binaural, 4 ambisonic; 1, the RIR's first channel, for the denoiser)
    before it crops them. ``with_rir``/``with_noise`` say what the run's
    batches carry."""

    with_rir: bool = True
    with_noise: bool = True
    n_channels: int = 2
    original_sr: int = 32000  # the scene-synthesis rate


def build_scenes(sc: NatSceneConfig, sample_rate: int, batch: dict,
                 rir_bank: Optional[dict] = None) -> torch.Tensor:
    """A scene batch → (B, sc.n_channels, T) f32 scenes at ``sample_rate``.
    RIRs come inline (``source_rir``, ``noise_rirs``) or from the bank by
    ``rir_index``; noise inline (``noise``, placed) or from the bank's faded
    rows by ``noise_index`` and ``noise_start``."""
    with torch.profiler.record_function("scene_synthesis"):
        source_rir, noise_rirs = batch.get("source_rir"), batch.get("noise_rirs")
        if sc.with_rir and source_rir is None:
            source_rir, noise_rirs = gather_scene_rirs(rir_bank, batch["rir_index"])
        noise = batch.get("noise")
        if sc.with_noise and noise is None:
            noise = place_noise_from_bank(rir_bank["noise"], batch["noise_index"],
                                          batch["noise_start"])
        scene = generate_scene(
            wire_to_f32(batch["audio"]), source_rir,
            None if noise is None else wire_to_f32(noise), noise_rirs,
            batch.get("noise_start"), batch.get("noise_length"), batch.get("snr"),
            with_rir=sc.with_rir, with_noise=sc.with_noise, n_channels=sc.n_channels)
        if sc.original_sr != sample_rate:
            scene = resample_torch(scene, sc.original_sr, sample_rate)
    return scene


def split_leaves(module: torch.nn.Module) -> list[bool]:
    """For each parameter of ``module``, in order, whether tensor
    parallelism splits it (``parallel/mesh.tp_rule``)."""
    return [tp_rule(name) is not None for name, _ in module.named_parameters()]


def optimizer_update(params: list, optimizer: torch.optim.Optimizer, lr: float,
                     grad_clip: float, split: list) -> torch.Tensor:
    """The update after the gradients: a zero gradient for each parameter
    without one (optax decays every parameter, with or without a gradient),
    clipping by global norm as optax does (t / ‖g‖ · max only when ‖g‖ ≥
    max), then one optimizer step at ``lr``. ``split`` (``split_leaves``
    of the module that holds ``params``) says which parameters tensor
    parallelism cuts into shards: the others' gradients are made equal
    over the tensor-parallel group first (``mean_over_model_group``), so
    that every rank keeps the same replicated weights, and the norm is the
    whole gradient's. Returns the norm before clipping."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    mean_over_model_group([g for g, s in zip(grads, split) if not s])
    g_norm = global_grad_norm(grads, split)
    keep = g_norm < grad_clip
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(g_norm), g_norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, grad_clip).to(g_norm))
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return g_norm


def make_optimizer(cfg: OptimizerConfig, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over every parameter of ``model`` in one group, weight decay
    included (``optax.adamw`` with no mask): the same update as optax's,
    eps outside the square root. The train step sets the group's learning
    rate from the warmup-cosine schedule before each update."""
    return torch.optim.AdamW(
        model.parameters(), lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
        weight_decay=cfg.weight_decay,
    )


def jepa_loss_fn(
    model: JEPA,
    teacher_encoder: TransformerEncoder,
    crops: torch.Tensor,
    ctx_mask: torch.Tensor,
    target_masks: torch.Tensor,
    visible_masks: torch.Tensor,
    return_terms: bool = False,
):
    """Student prediction loss against the teacher's targets. The student's
    features are computed once; the teacher runs them, detached, through
    its own encoder without a gradient. ``return_terms`` gives the
    unreduced (numerator, denominator)."""
    feats = model.encode_features(crops)
    with torch.no_grad():
        targets = model.teacher_forward(feats.detach(), teacher_encoder)
    if model.config.pack_encoder is not None:
        return model.packed_prediction_loss(feats, ctx_mask, visible_masks, targets,
                                            target_masks, return_terms)
    preds = model.student_forward(feats, ctx_mask, visible_masks)
    return masked_prediction_loss(preds, targets, target_masks, return_terms)


def canonicalize_for_packing(ctx_mask: torch.Tensor, target_masks: torch.Tensor,
                             pack_encoder: int, channels: int = 1):
    """Flip context-visible tokens past the ``pack_encoder`` budget to
    masked (per channel for channel-tiled masks, whose copies stay equal),
    and rebuild the predictor's masks as ctx XOR targets. Idempotent."""
    if channels > 1:
        vis = (~ctx_mask).reshape(ctx_mask.shape[0], channels, -1)
        over = (vis.cumsum(dim=-1) > pack_encoder // channels).reshape(ctx_mask.shape)
    else:
        over = (~ctx_mask).cumsum(dim=-1) > pack_encoder
    ctx_mask = ctx_mask | over
    return ctx_mask, ctx_mask[:, None, :] ^ target_masks


MaskerFn = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class JEPATrainStep:
    """``step(state, audio, generator) -> (state, metrics)``; see the module
    docstring for the order. ``state`` is updated in place and returned.
    ``metrics`` holds ``loss`` and ``grad_norm`` (the norm before clipping)
    as device tensors, and ``lr`` and ``ema_decay`` as floats. In a process
    group ``audio`` is this rank's rows of the global batch, ``step_on``'s
    crops and masks likewise, and the metrics are global."""

    def __init__(
        self,
        opt_cfg: OptimizerConfig,
        nr_samples_per_audio: int = 8,
        masker: Optional[MaskerFn] = None,
        masker_cfg: Any = None,
        ema_cfg: EMAConfig = EMAConfig(),
        accum_steps: int = 1,
        scene_cfg: Optional[NatSceneConfig] = None,
    ):
        self.scene_cfg = scene_cfg
        self.grad_clip = opt_cfg.grad_clip
        self.lr_schedule = warmup_cosine_schedule(opt_cfg.lr, opt_cfg.warmup_steps,
                                                  opt_cfg.total_steps)
        self.ema_schedule = ema_decay_schedule(ema_cfg.start_decay, ema_cfg.end_decay,
                                               ema_cfg.anneal_end_step)
        self.n_crops = nr_samples_per_audio
        self.masker = masker or time_inverse_block_masks
        self.masker_cfg = masker_cfg if masker_cfg is not None else TimeInverseMaskConfig()
        self.accum_steps = accum_steps

    def __call__(self, state: TrainState, audio, generator: torch.Generator,
                 rir_bank: Optional[dict] = None):
        """``audio`` is a (B, C, L) clip batch, or with ``scene_cfg`` a dict
        scene batch, whose indices read ``rir_bank``."""
        cfg = state.model.config
        if self.scene_cfg is not None:
            audio = self.scenes(cfg, audio, rir_bank)
        crops, ctx_mask, target_masks, visible_masks = self.prepare(cfg, audio, generator)
        return self.step_on(state, crops, ctx_mask, target_masks, visible_masks)

    def scenes(self, cfg, batch: dict, rir_bank: Optional[dict] = None) -> torch.Tensor:
        """A scene batch → (B, n_channels, T) f32 scenes at ``cfg``'s sample
        rate (``build_scenes``)."""
        return build_scenes(self.scene_cfg, cfg.sample_rate, batch, rir_bank)

    def prepare(self, cfg, audio: torch.Tensor, generator: torch.Generator):
        """(B, C, L) or (B, L) clips, this rank's rows of the global batch →
        crops (B·n, C, crop) in ``cfg.dtype`` and their masks. The starts and
        masks are drawn from ``generator`` for the global batch (W·B clips at
        data-parallel world size W), and this rank's rows taken."""
        audio = wire_to_f32(audio)
        if audio.dim() == 2:
            audio = audio[:, None, :]
        _, world = data_group()
        starts = random_starts(generator, audio, cfg.target_length, self.n_crops,
                               n_clips=audio.shape[0] * world)
        crops = crops_at(audio, shard_batch(starts), cfg.target_length)
        crops = instance_normalize(crops, dims=(-2, -1))
        b, s, c, length = crops.shape
        crops = crops.reshape(b * s, c, length).to(cfg.dtype)
        masks = self.masker(generator, batch_size=b * s * world, n_times=cfg.total_patches,
                            in_channels=cfg.in_channels, cfg=self.masker_cfg)
        return (crops, *(shard_batch(m) for m in masks))

    def step_on(self, state: TrainState, crops, ctx_mask, target_masks, visible_masks):
        model, cfg = state.model, state.model.config
        if cfg.pack_encoder is not None:
            chans = cfg.in_channels if self.masker_cfg.channel_based_masking else 1
            ctx_mask, visible_masks = canonicalize_for_packing(
                ctx_mask, target_masks, cfg.pack_encoder, chans)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        n_rows = crops.shape[0]
        world = data_group()[1]
        if self.accum_steps > 1 or world > 1:
            if n_rows % self.accum_steps:
                raise ValueError(f"crop batch {n_rows} not divisible by "
                                 f"accum_steps={self.accum_steps}")
            mb = n_rows // self.accum_steps
            num_sum = den_sum = 0.0
            for i in range(self.accum_steps):
                part = slice(i * mb, (i + 1) * mb)
                num, den = jepa_loss_fn(model, state.teacher_encoder, crops[part],
                                        ctx_mask[part], target_masks[part],
                                        visible_masks[part], return_terms=True)
                num.backward()  # the gradients sum ∇num over microbatches
                num_sum = num_sum + num.detach()
                den_sum = den_sum + den
            if world > 1:  # global numerator, target count and gradients
                num_sum, den_sum = all_reduce_gradients(params, num_sum, den_sum,
                                                        group=data_process_group())
            inv = 1.0 / (den_sum + 1e-8)
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            loss = num_sum * inv
        else:
            loss = jepa_loss_fn(model, state.teacher_encoder, crops, ctx_mask,
                                target_masks, visible_masks)
            loss.backward()
            loss = loss.detach()
        # EMA from the student encoder before its update, then the update
        decay = self.ema_schedule(state.step)
        ema_update(state.teacher_encoder, model.encoder, decay)
        lr = self.lr_schedule(state.step)
        g_norm = optimizer_update(params, state.optimizer, lr, self.grad_clip,
                                  split_leaves(model))
        state.step += 1
        return state, {"loss": loss, "ema_decay": decay, "lr": lr, "grad_norm": g_norm}


def make_jepa_train_step(
    opt_cfg: OptimizerConfig,
    nr_samples_per_audio: int = 8,
    masker: Optional[MaskerFn] = None,
    masker_cfg: Any = None,
    ema_cfg: EMAConfig = EMAConfig(),
    scene_cfg: Optional[NatSceneConfig] = None,
    accum_steps: int = 1,
) -> JEPATrainStep:
    """The train step for a run; ``accum_steps > 1`` splits the crop batch
    into that many microbatches, exactly; ``scene_cfg`` makes it a
    WavJEPA-Nat step on scene batches."""
    return JEPATrainStep(opt_cfg, nr_samples_per_audio, masker, masker_cfg, ema_cfg,
                         accum_steps, scene_cfg)
