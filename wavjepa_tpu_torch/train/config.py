"""The run configuration: a dataclass tree (data / extractor / masker /
optimizer / ema / trainer), YAML files and dotted command-line overrides.

Counterpart of ``wavjepa_tpu/train/config.py``, field for field, so one YAML
file configures both packages. PyYAML is imported only when a file is read.

    cfg = load_config()                          # all defaults
    cfg = load_config("configs/audioset.yaml")
    cfg = apply_overrides(cfg, ["data.synthetic=true", "trainer.steps=2"])
    model_cfg = cfg.build_model_config()
"""

from __future__ import annotations

import dataclasses
import json
import logging
import typing
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from wavjepa_tpu_torch.data.pipeline import process_group, rank_batch_size
from wavjepa_tpu_torch.masking import (
    SpeechMaskConfig,
    TimeInverseMaskConfig,
    speech_masks,
    time_inverse_block_masks,
)
from wavjepa_tpu_torch.models.jepa import JEPAConfig
from wavjepa_tpu_torch.ops.conv_frontend import WAV2VEC2_CONV_SPEC, WAVJEPA_CONV_SPEC
from wavjepa_tpu_torch.parallel.layout import data_world
from wavjepa_tpu_torch.train.step import EMAConfig, OptimizerConfig


@dataclasses.dataclass
class DataConfig:
    name: str = "AudioSet"
    data_dirs: Any = ""  # shard pattern(s): str or list[str]
    mixing_weights: Optional[list[float]] = None
    sr: int = 16000
    in_channels: int = 1
    samples_per_audio: int = 8
    process_seconds: float = 2.01
    target_seconds: float = 10.0
    # denoise / Nat scene synthesis
    noise_dir: str = ""
    rir_dir: str = ""
    with_rir: bool = True
    with_noise: bool = True
    nat_scenes: bool = False
    snr_low: float = -5.0
    snr_high: float = 5.0
    # host pipeline
    num_workers: int = 16
    shuffle_buffer: int = 1000
    prefetch: int = 2
    transfer_dtype: str = "int16"  # host→device wire format of clip batches
    rir_bank_size: int = 64
    noise_bank_size: int = 64
    rir_refresh_per_batch: int = 1
    synthetic: bool = False  # random-audio source for smoke runs


@dataclasses.dataclass
class ExtractorConfig:
    name: str = "wavjepa"  # "wavjepa" | "wav2vec2" | custom
    conv_spec: Optional[list[list[int]]] = None  # [[dim, k, stride], ...]
    mode: str = "default"
    conv_bias: bool = False
    depthwise: bool = False
    channel_wise: bool = False  # per-channel CNNs (Nat)
    share_weights_over_channels: bool = False
    pos_embed: str = "time"  # "time" | "binaural" (Nat)

    def resolved_spec(self) -> tuple[tuple[int, int, int], ...]:
        if self.conv_spec is not None:
            return tuple(tuple(layer) for layer in self.conv_spec)
        return {"wavjepa": WAVJEPA_CONV_SPEC, "wav2vec2": WAV2VEC2_CONV_SPEC}[self.name]


@dataclasses.dataclass
class MaskerConfig:
    name: str = "time-inverse"  # "time-inverse" | "speech-masker"
    target_masks_per_context: int = 4
    context_mask_prob: float = 0.65
    context_mask_length: int = 10
    target_prob: float = 0.25
    target_length: int = 10
    ratio_cutoff: float = 0.1
    min_context_len: int = 5
    channel_based_masking: bool = False

    def build(self):
        """→ (masker_fn, masker_cfg) for train/step.py."""
        if self.name == "speech-masker":
            return speech_masks, SpeechMaskConfig(
                target_masks_per_context=self.target_masks_per_context,
                target_prob=self.target_prob,
                target_length=self.target_length,
                min_context_len=self.min_context_len,
                ratio_cutoff=self.ratio_cutoff,
                channel_based_masking=self.channel_based_masking,
            )
        return time_inverse_block_masks, TimeInverseMaskConfig(
            target_masks_per_context=self.target_masks_per_context,
            context_mask_prob=self.context_mask_prob,
            context_mask_length=self.context_mask_length,
            target_prob=self.target_prob,
            target_length=self.target_length,
            ratio_cutoff=self.ratio_cutoff,
            channel_based_masking=self.channel_based_masking,
        )


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 375_000
    batch_size: int = 32  # clips per step, over all data-parallel ranks
    precision: str = "bf16"  # "bf16" | "f32"
    size: str = "base"  # "base" | "large"
    average_top_k_layers: int = 8
    # ranks: 0 = as many as the launch started (torchrun), or exactly that
    # many (check_devices)
    num_devices: int = 0
    # ranks to a tensor-parallel group (parallel/mesh.init_layout); the
    # others are data-parallel
    model_parallel: int = 1
    # recomputation flags, kept so that configurations round-trip; the port
    # keeps every activation (no recomputation yet)
    remat: bool = True
    remat_conv: Optional[bool] = None
    remat_encoder: Optional[bool] = None
    remat_decoder: Optional[bool] = None
    remat_save_probs: bool = False
    # visible-token packing: "auto" | "exact" | "off" (see packing_bounds)
    pack_tokens: str = "auto"
    # microbatches a step is split into, exactly (0 = auto, see
    # resolved_accum_steps)
    accum_steps: int = 0
    attn_impl: str = "auto"
    attn_impl_decoder: Optional[str] = None
    ckpt_every: int = 25_000
    keep_ckpts: int = 0  # 0 = keep all
    log_every: int = 50
    save_dir: str = "runs"
    seed: int = 42


@dataclasses.dataclass
class Config:
    model: str = "JEPA"  # "JEPA" | "Denoiser"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    extractor: ExtractorConfig = dataclasses.field(default_factory=ExtractorConfig)
    masker: MaskerConfig = dataclasses.field(default_factory=MaskerConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    ema: EMAConfig = dataclasses.field(default_factory=EMAConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    # denoiser-only
    alpha: float = 0.0
    teacher_ckpt: str = ""
    log_clean_loss: bool = True
    # dotted keys the user set (YAML file or override)
    explicit_keys: set = dataclasses.field(default_factory=set, repr=False, compare=False)

    def run_identity(self) -> str:
        """Hierarchical run name from the configuration (the reference's)."""
        m = self.masker
        return "/".join([
            f"Data={self.data.name}",
            f"Extractor={self.extractor.name}",
            f"InSeconds={self.data.process_seconds}",
            f"BatchSize={self.trainer.batch_size}",
            f"NrSamples={self.data.samples_per_audio}",
            f"ModelSize={self.trainer.size}",
            f"LR={self.optimizer.lr}",
            f"Masking={m.name}",
            f"TargetProb={m.target_prob}",
            f"TargetLen={m.target_length}",
            f"TopK={self.trainer.average_top_k_layers}",
        ])

    def packing_bounds(self, total_patches: int) -> tuple:
        """(pack_encoder, pack_decoder) for the time-inverse masker, or
        (None, None).

        The encoder budget is the p99.9 visible-context count of 16384
        numpy draws of the span sampler (a fixed seed, so the result is
        deterministic) plus one context-span length, rounded up to 8 (88 at
        the AudioSet defaults); the train step canonicalises the rarer
        overflow. With most tokens visible (> 72%) packing is off. The
        decoder budget is the encoder budget plus the masker's largest
        target coverage, a hard bound; under "auto" it snaps down to 128
        when at most 3e-4 of the sampled groups see more (targets are packed
        first, so only context keys can fall out of that tail)."""
        m = self.masker
        if self.trainer.pack_tokens not in ("auto", "exact", "off"):
            raise ValueError(
                f"trainer.pack_tokens must be 'auto', 'exact' or 'off', got "
                f"{self.trainer.pack_tokens!r} (note: YAML booleans parse as "
                f"bool, quote the string)"
            )
        if self.trainer.pack_tokens == "off" or m.name != "time-inverse":
            return None, None
        c = max(1, self.data.in_channels if m.channel_based_masking else 1)
        t = total_patches // c
        ctx_counts, grp_counts = _sampled_visible_stats(
            t, m.context_mask_prob, m.context_mask_length,
            m.target_prob, m.target_length, m.target_masks_per_context,
        )
        q999 = float(np.percentile(ctx_counts, 99.9))
        pe = min(t, -(-int(q999 + m.context_mask_length) // 8) * 8)
        if pe >= 0.72 * t:
            return None, None
        max_tgt = (int(m.target_prob * t / m.target_length) + 1) * m.target_length
        pd = min(t, -(-(pe + max_tgt) // 8) * 8)
        snap = max(128, -(-max_tgt // 8) * 8)
        frac_over = float((grp_counts > snap).mean())
        if self.trainer.pack_tokens == "auto" and snap <= pd and frac_over <= 3e-4 and t > 160:
            if frac_over > 0.0:
                logging.getLogger(__name__).warning(
                    "pack_tokens=auto snaps pack_decoder %d -> %d; sampled fraction of "
                    "decoder groups over the budget = %.2e", pd, snap, frac_over)
            pd = snap
        return pe * c, pd * c

    def resolved_accum_steps(self) -> int:
        """trainer.accum_steps, with 0 = auto: at a crop batch of 256 or
        more (channel-weighted) the largest of 16/8/4/2 that divides it,
        else 1. The JAX package's rule, kept so both resolve alike; the
        port's own choice on an H100 is open (ROADMAP)."""
        a = self.trainer.accum_steps
        if a != 0:
            return a
        crops = self.trainer.batch_size * self.data.samples_per_audio
        if crops * self.data.in_channels >= 256:
            for cand in (16, 8, 4, 2):
                if crops % cand == 0:
                    return cand
        return 1

    def check_devices(self, accum_steps: int) -> None:
        """Raise on device settings this process cannot honour. The world
        size is that of the torch.distributed process group this process
        belongs to (1 without one): ``trainer.num_devices`` is 0 (whatever
        the launch gave) or must equal it, so that a run that asked for
        several cards never trains on one unawares.
        ``trainer.model_parallel`` (mp) must divide it: a run at mp 2 needs
        a group of two ranks or more. The world / mp data-parallel ranks
        split ``trainer.batch_size``, the global batch, into equal shares,
        each of whose crops split into ``accum_steps`` microbatches."""
        tr = self.trainer
        _, world = process_group()
        if tr.num_devices not in (0, world):
            raise RuntimeError(
                f"trainer.num_devices={tr.num_devices}, but this process is one of {world} "
                f"rank(s): launch the run with torchrun "
                f"--nproc_per_node={tr.num_devices}, or set trainer.num_devices=0")
        world = data_world(world, tr.model_parallel)
        if world > 1:
            crops = rank_batch_size(tr.batch_size, world) * self.data.samples_per_audio
            if crops % accum_steps:
                raise ValueError(f"a rank's {crops} crops do not split into {accum_steps} "
                                 f"microbatches (trainer.accum_steps)")

    def resolved_denoise_accum_steps(self) -> int:
        """The denoise step's microbatches: trainer.accum_steps, with 0 =
        auto: at a crop batch of 128 or more the largest of 4/2 that
        divides it, else 1. The JAX package's rule (the denoise step has no
        predictor and no packing, so its rule is not SSL's)."""
        a = self.trainer.accum_steps
        if a != 0:
            return a
        crops = self.trainer.batch_size * self.data.samples_per_audio
        if crops >= 128:
            for cand in (4, 2):
                if crops % cand == 0:
                    return cand
        return 1

    def build_denoise_model_config(self) -> JEPAConfig:
        """The JEPAConfig of a denoise run: the teacher's and the student's.
        Packing stays off (the denoise step runs whole sequences); with
        microbatches and ``trainer.remat`` not set, ``remat`` goes off; the
        explicit recomputation flags and the attention choices come from the
        trainer, as the JAX package resolves them (the port does no
        recomputation yet: the flags only round-trip). Raises on
        device settings this process cannot honour (``check_devices``)."""
        self.check_devices(self.resolved_denoise_accum_steps())
        cfg = self._base_model_config()
        tr = self.trainer
        if self.resolved_denoise_accum_steps() > 1 and "trainer.remat" not in self.explicit_keys:
            cfg = dataclasses.replace(cfg, remat=False)
        return dataclasses.replace(
            cfg,
            remat_conv=tr.remat_conv,
            remat_encoder=tr.remat_encoder,
            remat_decoder=tr.remat_decoder,
            remat_save_probs=tr.remat_save_probs,
            attn_impl=tr.attn_impl,
            attn_impl_decoder=tr.attn_impl_decoder,
        )

    def build_model_config(self) -> JEPAConfig:
        """The JEPAConfig of this run, with packing and the recomputation
        flags resolved as the JAX package resolves them. Raises on device
        settings this process cannot honour (``check_devices``)."""
        self.check_devices(self.resolved_accum_steps())
        cfg = self._base_model_config()
        pe, pd = self.packing_bounds(cfg.total_patches)
        if pe is not None:
            cfg = dataclasses.replace(cfg, pack_encoder=pe, pack_decoder=pd)
        tr = self.trainer
        remat_conv, remat_enc, remat_dec = tr.remat_conv, tr.remat_encoder, tr.remat_decoder
        if pe is not None and tr.remat:
            remat_conv = False if remat_conv is None else remat_conv
            remat_enc = False if remat_enc is None else remat_enc
        if self.resolved_accum_steps() > 1 and remat_dec is None:
            remat_dec = False
        return dataclasses.replace(
            cfg,
            remat_conv=remat_conv,
            remat_encoder=remat_enc,
            remat_decoder=remat_dec,
            remat_save_probs=tr.remat_save_probs,
            attn_impl=tr.attn_impl,
            attn_impl_decoder=tr.attn_impl_decoder,
        )

    def _base_model_config(self) -> JEPAConfig:
        return JEPAConfig(
            conv_spec=self.extractor.resolved_spec(),
            in_channels=self.data.in_channels,
            extractor="conv_channel" if self.extractor.channel_wise else "conv",
            extractor_mode=self.extractor.mode,
            conv_bias=self.extractor.conv_bias,
            share_weights_over_channels=self.extractor.share_weights_over_channels,
            pos_embed=self.extractor.pos_embed,
            size=self.trainer.size,
            sample_rate=self.data.sr,
            process_seconds=self.data.process_seconds,
            average_top_k_layers=self.trainer.average_top_k_layers,
            dtype=torch.bfloat16 if self.trainer.precision == "bf16" else torch.float32,
            remat=self.trainer.remat,
        )


_VISIBLE_STATS_CACHE: dict = {}


def _batch_span_masks(rng, n_rows: int, t: int, prob: float, length: int) -> np.ndarray:
    """Vectorised numpy twin of ``masking.span.sample_span_mask_np``:
    (n_rows, t) bool masks, each the union of ``floor(prob·t/length + U)``
    spans of ``length`` placed without replacement (the k smallest of iid
    uniform keys are a uniform k-subset). Coverage by +1/−1 boundary marks
    and a cumulative sum."""
    base = prob * t / length
    dom = max(1, t - length)
    nums = np.minimum(
        np.floor(base + rng.random(n_rows, dtype=np.float32)).astype(np.int64), dom)
    mmax = int(min(int(base) + 1, dom))
    keys = rng.random((n_rows, dom), dtype=np.float32)
    if mmax >= dom:
        starts = np.argsort(keys, axis=1)[:, :mmax]
    else:
        starts = np.argpartition(keys, mmax, axis=1)[:, :mmax]
    valid = np.arange(mmax)[None, :] < nums[:, None]
    w = t + length
    rows = np.broadcast_to(np.arange(n_rows)[:, None], starts.shape)
    lin = rows[valid].astype(np.int64) * w + starts[valid]
    marks = np.bincount(lin, minlength=n_rows * w) - np.bincount(lin + length,
                                                                 minlength=n_rows * w)
    return np.cumsum(marks.reshape(n_rows, w)[:, :t], axis=1) > 0


def _sampled_visible_stats(t: int, ctx_prob: float, ctx_len: int, tgt_prob: float,
                           tgt_len: int, n_targets: int, n_samples: int = 16384,
                           seed: int = 0):
    """(visible-context counts, per-group visible counts) of ``n_samples``
    draws of the time-inverse masker's spans, unconditioned by the ratio
    cutoff. Deterministic (fixed seed) and cached per configuration."""
    key = (t, ctx_prob, ctx_len, tgt_prob, tgt_len, n_targets, n_samples, seed)
    if key in _VISIBLE_STATS_CACHE:
        return _VISIBLE_STATS_CACHE[key]
    rng = np.random.default_rng(seed)
    cover = _batch_span_masks(rng, n_samples, t, ctx_prob, ctx_len)
    tgts = _batch_span_masks(rng, n_samples * n_targets, t, tgt_prob, tgt_len
                             ).reshape(n_samples, n_targets, t)
    vis = ~cover & ~tgts.any(axis=1)
    nv = vis.sum(axis=1)
    grp = nv + tgts.sum(axis=2).max(axis=1)  # targets never overlap the context
    out = (nv.astype(np.int64), grp.astype(np.int64))
    _VISIBLE_STATS_CACHE[key] = out
    return out


# --------------------------------------------------------------- (de)serialise

_SUBCONFIGS = {
    (Config, "data"): DataConfig,
    (Config, "extractor"): ExtractorConfig,
    (Config, "masker"): MaskerConfig,
    (Config, "optimizer"): OptimizerConfig,
    (Config, "ema"): EMAConfig,
    (Config, "trainer"): TrainerConfig,
}


def _from_dict(cls, data: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key '{key}' for {cls.__name__}")
        sub = _SUBCONFIGS.get((cls, key))
        kwargs[key] = _from_dict(sub, value) if sub and isinstance(value, dict) else value
    return cls(**kwargs)


def load_config(path: Optional[str] = None, data: Optional[dict] = None) -> Config:
    """A Config from a YAML file (PyYAML needed only here) or an already
    parsed dict; all defaults without either."""
    if data is None:
        if path is None:
            return Config()
        import yaml

        data = yaml.safe_load(Path(path).read_text()) or {}
    cfg = _from_dict(Config, data)

    def walk(d: dict, prefix: str = ""):
        for k, v in (d or {}).items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                cfg.explicit_keys.add(f"{prefix}{k}")

    walk(data)
    return cfg


def _optional_base(decl: Any) -> Any:
    """Optional[X] → X (None if ``decl`` is not a one-type Optional)."""
    args = typing.get_args(decl)
    non_none = [a for a in args if a is not type(None)]
    if type(None) in args and len(non_none) == 1:
        return non_none[0]
    return None


def _coerce(value: str, current: Any, decl: Any = None) -> Any:
    """A command-line string → the field's type, judged by its current
    value, or by its declared type where the current value is None."""
    if value.lower() in ("null", "none"):
        # before the bool branch: "null" clears an Optional[bool], it does
        # not make it False; a field that is not Optional cannot be cleared
        if current is None or decl is None or type(None) in typing.get_args(decl):
            return None
        raise ValueError(f"cannot set non-Optional field (declared {decl!r}) to {value!r}")
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if value.startswith(("[", "{")):
        return json.loads(value)
    if current is None:
        base = _optional_base(decl) if decl is not None else None
        if base is bool:
            return value.lower() in ("1", "true", "yes")
        if base is int:
            return int(value)
        if base is float:
            return float(value)
        if base is None and value.lower() in ("true", "false", "yes", "no"):
            return value.lower() in ("true", "yes")
    return value


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Dotted overrides such as ``trainer.batch_size=64``; frozen
    sub-configurations (optimizer, ema) are rebuilt with
    ``dataclasses.replace``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not key=value")
        dotted, value = item.split("=", 1)
        keys = dotted.split(".")
        objs = [cfg]
        for key in keys[:-1]:
            objs.append(getattr(objs[-1], key))
        leaf_obj, leaf_key = objs[-1], keys[-1]
        current = getattr(leaf_obj, leaf_key)
        decl = (typing.get_type_hints(type(leaf_obj)).get(leaf_key)
                if dataclasses.is_dataclass(leaf_obj) else None)
        updated = _coerce(value, current, decl)
        cfg.explicit_keys.add(dotted)
        for obj, key in zip(reversed(objs), reversed(keys)):
            if dataclasses.is_dataclass(obj) and obj.__dataclass_params__.frozen:
                updated = dataclasses.replace(obj, **{key: updated})
            else:
                setattr(obj, key, updated)
                break
    return cfg


def config_to_dict(cfg: Config) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("explicit_keys", None)  # bookkeeping, not configuration
    return d
