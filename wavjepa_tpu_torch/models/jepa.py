"""WavJEPA model: configuration, the student and the EMA teacher's targets.

Counterpart of ``wavjepa_tpu/models/jepa.py``. ``JEPAConfig`` is carried
over whole, so configurations round-trip between the two packages. ``JEPA``
holds, under the reference's module names:

  * the path that serves (``represent``): conv frontend (one stack, or one
    a channel for WavJEPA-Nat's ``extractor="conv_channel"``, its tokens
    channel-major) → feature LayerNorm
    (eps 1e-5) → 512→768 mapper → fixed sin-cos positions added in the
    activation dtype → post-norm context encoder;
  * the training side: ``student_forward`` (encoder on the context → 768→384
    mapper → mask-token canvas with decoder positions → predictor per target
    group → 384→768 mapper), unpacked or with visible tokens packed into
    ``pack_encoder``/``pack_decoder`` slots; ``teacher_forward`` (the top-k
    raw layer outputs of a teacher encoder, each instance-normed, averaged);
    and the masked MSE in both layouts.

``EncoderPath`` is the serving path alone, which ``JEPA`` extends and the
denoiser's student is. Both take ``model_parallel`` (tensor parallelism,
``parallel/mesh.py``): their transformer stacks then hold a rank's shard
(H/mp heads and mlp_dim/mp hidden units a block; a block refuses a head
count or an ``mlp_dim`` that mp does not divide, naming it). Such a model is not
initialised itself: the whole model is, from the seed, and each rank takes
its shard of it (``parallel/mesh.sharded``), so that every mp starts from
the same weights. The EMA teacher is a second encoder module,
``build_teacher_encoder()``, owned by the train state (``train/state.py``),
as the JAX package keeps a second parameter tree for the same encoder
definition.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from wavjepa_tpu_torch.ops.conv_frontend import (
    ConvChannelFeatureExtractor,
    ConvFeatureExtractor,
    ConvSpec,
    WAVJEPA_CONV_SPEC,
    conv_output_length,
)
from wavjepa_tpu_torch.ops.pos_embed import (
    get_1d_sincos_pos_embed_from_grid,
    get_binaural_pos_embed,
)
from wavjepa_tpu_torch.ops.transformer import (
    LayerNorm32,
    Linear,
    TransformerEncoder,
    check_attn_impl,
)


@dataclasses.dataclass(frozen=True)
class JEPAConfig:
    """Static model configuration, field for field the JAX package's."""

    # frontend
    conv_spec: ConvSpec = WAVJEPA_CONV_SPEC
    in_channels: int = 1
    extractor: str = "conv"  # "conv" | "conv_channel"
    extractor_mode: str = "default"  # "default" | "layer_norm"
    conv_bias: bool = False
    share_weights_over_channels: bool = False
    # encoder / decoder
    encoder_layers: int = 12
    encoder_dim: int = 768
    encoder_heads: int = 12
    decoder_layers: int = 12
    decoder_dim: int = 384
    decoder_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    size: str = "base"  # "large": 24L/1024d/16h; "tiny": a CPU smoke model
    # input contract
    sample_rate: int = 16000
    process_seconds: float = 2.01
    # teacher
    average_top_k_layers: int = 8
    # positions: "time" (1-D sincos over all tokens) | "binaural"
    pos_embed: str = "time"
    # training-only fields, kept so configurations round-trip
    pack_encoder: Optional[int] = None
    pack_decoder: Optional[int] = None
    remat_encoder: Optional[bool] = None
    remat_decoder: Optional[bool] = None
    remat_conv: Optional[bool] = None
    remat_save_probs: bool = False
    # compute dtype; parameters stay float32
    dtype: Any = torch.float32
    remat: bool = True
    attn_impl: str = "auto"
    attn_impl_decoder: Optional[str] = None

    def __post_init__(self):
        if self.size == "large":
            object.__setattr__(self, "encoder_layers", 24)
            object.__setattr__(self, "encoder_dim", 1024)
            object.__setattr__(self, "encoder_heads", 16)
        elif self.size == "tiny":
            object.__setattr__(self, "encoder_layers", 2)
            object.__setattr__(self, "encoder_dim", 32)
            object.__setattr__(self, "encoder_heads", 4)
            object.__setattr__(self, "decoder_layers", 2)
            object.__setattr__(self, "decoder_dim", 16)
            object.__setattr__(self, "decoder_heads", 4)

    @property
    def target_length(self) -> int:
        return int(self.sample_rate * self.process_seconds)

    @property
    def frames_per_window(self) -> int:
        return conv_output_length(self.target_length, self.conv_spec)

    @property
    def total_patches(self) -> int:
        n = self.frames_per_window
        if self.extractor == "conv_channel":
            n *= self.in_channels
        return n

    @property
    def embedding_dim(self) -> int:
        return self.conv_spec[-1][0]

    def pos_table(self, dim: int) -> np.ndarray:
        if self.pos_embed == "binaural":
            table = get_binaural_pos_embed(dim, self.frames_per_window)
        else:
            table = get_1d_sincos_pos_embed_from_grid(
                dim, np.arange(self.total_patches, dtype=np.float64)
            )
        return table.astype(np.float32)[None]  # (1, T, dim)


_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def jepa_config_to_dict(cfg: JEPAConfig) -> dict:
    """JSON-serialisable dict of a JEPAConfig, in the JAX package's format."""
    d = dataclasses.asdict(cfg)
    d["conv_spec"] = [list(layer) for layer in cfg.conv_spec]
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return d


def jepa_config_from_dict(d: dict) -> JEPAConfig:
    """Inverse of jepa_config_to_dict; unknown keys are ignored."""
    fields = {f.name for f in dataclasses.fields(JEPAConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    if "conv_spec" in kw:
        kw["conv_spec"] = tuple(tuple(layer) for layer in kw["conv_spec"])
    if "dtype" in kw and isinstance(kw["dtype"], str):
        kw["dtype"] = _DTYPE_NAMES[kw["dtype"]]
    return JEPAConfig(**kw)


ENCODER_SIDE = ("extract_audio.", "feature_norms.", "post_extraction_mapper.", "encoder.")


class EncoderPath(nn.Module):
    """The path that serves, under the reference's module names: the conv
    frontend, ``feature_norms``, ``post_extraction_mapper`` and the context
    ``encoder`` (their state-dict keys start with ``ENCODER_SIDE``), and the
    encoder's fixed position table. ``JEPA`` adds the training side; the
    denoiser's student (``models/denoiser.py``) is this path alone."""

    def __init__(self, config: JEPAConfig, model_parallel: int = 1):
        super().__init__()
        cfg = config
        self.model_parallel = model_parallel
        if cfg.extractor not in ("conv", "conv_channel"):
            raise ValueError(f"unknown extractor {cfg.extractor!r}")
        check_attn_impl(cfg.attn_impl)
        self.config = cfg
        if cfg.extractor == "conv_channel":  # WavJEPA-Nat: a stack a channel
            self.extract_audio = ConvChannelFeatureExtractor(
                cfg.conv_spec, cfg.in_channels, cfg.extractor_mode, cfg.conv_bias,
                cfg.share_weights_over_channels, cfg.dtype,
            )
        else:
            self.extract_audio = ConvFeatureExtractor(
                cfg.conv_spec, cfg.in_channels, cfg.extractor_mode, cfg.conv_bias, cfg.dtype
            )
        self.feature_norms = LayerNorm32(cfg.embedding_dim, eps=1e-5, dtype=cfg.dtype)
        self.post_extraction_mapper = (
            Linear(cfg.embedding_dim, cfg.encoder_dim, dtype=cfg.dtype)
            if cfg.embedding_dim != cfg.encoder_dim
            else None
        )
        self.encoder = TransformerEncoder(
            cfg.encoder_layers, cfg.encoder_dim, cfg.encoder_heads,
            int(cfg.encoder_dim * cfg.mlp_ratio), cfg.layer_norm_eps, cfg.dtype,
            cfg.attn_impl, model_parallel,
        )
        # a fixed table, not a parameter: derived from the config, not stored
        self.register_buffer("pos_encoding_encoder",
                             torch.from_numpy(cfg.pos_table(cfg.encoder_dim)), persistent=False)

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights with the JAX package's initialisers, from
        ``generator`` (a CPU generator gives the same weights on any device
        when the model is built on the CPU and moved)."""
        self.extract_audio.init_parameters(generator)
        if self.post_extraction_mapper is not None:
            nn.init.trunc_normal_(
                self.post_extraction_mapper.weight, 0.0, 0.02, -0.04, 0.04,
                generator=generator,
            )
        self.encoder.init_parameters(generator)

    def encode_features(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, C, T_samples) → (B, total_patches, D_enc) positioned features."""
        x = self.feature_norms(self.extract_audio(audio))
        if self.post_extraction_mapper is not None:
            x = self.post_extraction_mapper(x)
        return x + self.pos_encoding_encoder.to(x.dtype)

    def represent(self, audio: torch.Tensor,
                  padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inference: features → context encoder under the padding mask."""
        return self.encoder(self.encode_features(audio), key_padding_mask=padding_mask)


class JEPA(EncoderPath):
    """The WavJEPA student under the reference's module names."""

    def __init__(self, config: JEPAConfig, model_parallel: int = 1):
        super().__init__(config, model_parallel)
        cfg = config
        if cfg.attn_impl_decoder is not None:
            check_attn_impl(cfg.attn_impl_decoder)
        self.decoder = TransformerEncoder(
            cfg.decoder_layers, cfg.decoder_dim, cfg.decoder_heads,
            int(cfg.decoder_dim * cfg.mlp_ratio), cfg.layer_norm_eps, cfg.dtype,
            cfg.attn_impl if cfg.attn_impl_decoder is None else cfg.attn_impl_decoder,
            model_parallel,
        )
        self.encoder_to_decoder_mapper = Linear(cfg.encoder_dim, cfg.decoder_dim, dtype=cfg.dtype)
        self.decoder_to_encoder_mapper = Linear(cfg.decoder_dim, cfg.encoder_dim, dtype=cfg.dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.decoder_dim))
        self.register_buffer("pos_encoding_decoder",
                             torch.from_numpy(cfg.pos_table(cfg.decoder_dim)), persistent=False)

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # the training side after the encoder side, so that one seed gives
        # the serving path the same weights as before it existed
        super().init_parameters(generator)
        self.decoder.init_parameters(generator)
        for lin in (self.encoder_to_decoder_mapper, self.decoder_to_encoder_mapper):
            nn.init.trunc_normal_(lin.weight, 0.0, 0.02, -0.04, 0.04, generator=generator)
        self.mask_token.copy_(0.02 * torch.randn(self.mask_token.shape, generator=generator))

    def build_teacher_encoder(self) -> TransformerEncoder:
        """A copy of the context encoder (its attn_impl too, as the JAX
        teacher runs the encoder module), outside autograd, for the EMA
        teacher."""
        teacher = copy.deepcopy(self.encoder)
        teacher.requires_grad_(False)
        return teacher

    # ------------------------------------------------------------ student

    def student_forward(self, local_features: torch.Tensor, ctx_mask: torch.Tensor,
                        ctx_and_target_mask: torch.Tensor) -> torch.Tensor:
        """Masked-prediction pass.

        local_features (B, T, D_enc); ctx_mask (B, T) bool, True = not
        context; ctx_and_target_mask (B, N, T) bool, True = masked for that
        target group's predictor (context ∪ its targets visible). Returns
        (B, N, T, D_enc); with packing, positions outside a group's pack are
        zero (the loss reads only targets, which are always packed)."""
        if self.config.pack_encoder is not None:
            preds_p, order_d, valid_d = self._packed_predictions(
                local_features, ctx_mask, ctx_and_target_mask)
            b, t, _ = local_features.shape
            n, pd = ctx_and_target_mask.shape[1], self.config.pack_decoder
            de = preds_p.shape[-1]
            # scatter into t + 1 rows, invalid slots to the last, then drop it
            index = torch.where(valid_d, order_d, t).reshape(b * n, pd, 1).expand(-1, -1, de)
            preds = preds_p.new_zeros(b * n, t + 1, de).scatter(1, index, preds_p)
            return preds[:, :t].reshape(b, n, t, de)
        b, t, _ = local_features.shape
        n = ctx_and_target_mask.shape[1]
        enc_out = self.encoder(local_features, key_padding_mask=ctx_mask)
        projected = self.encoder_to_decoder_mapper(enc_out)  # (B, T, D_dec)
        # the reference gathers the context, then scatters it back into the
        # mask-token canvas at the same positions: a select
        dec_in = torch.where(ctx_mask[..., None], self.mask_token.to(projected.dtype), projected)
        dec_in = dec_in + self.pos_encoding_decoder.to(dec_in.dtype)
        dd = dec_in.shape[-1]
        dec_in = dec_in[:, None].expand(b, n, t, dd).reshape(b * n, t, dd)
        dec_out = self.decoder(dec_in, key_padding_mask=ctx_and_target_mask.reshape(b * n, t))
        return self.decoder_to_encoder_mapper(dec_out).reshape(b, n, t, -1)

    def _packed_predictions(self, local_features, ctx_mask, ctx_and_target_mask):
        """Packed encoder → decoder pass → (preds_p (B·N, Pd, D_enc),
        order_d (B, N, Pd) token indices, valid_d (B, N, Pd)).

        Requires at most ``pack_encoder`` context tokens per row (the train
        step enforces it). The decoder packs targets first (rank 0 = target,
        1 = visible context, 2 = masked), so targets are always packed; if a
        group sees more than ``pack_decoder`` tokens, its positionally last
        context keys fall out."""
        cfg = self.config
        b, t, de = local_features.shape
        n = ctx_and_target_mask.shape[1]
        pe, pd = cfg.pack_encoder, cfg.pack_decoder

        # encoder on the packed visible context, positions in order
        order_e = torch.argsort(ctx_mask.to(torch.uint8), dim=-1, stable=True)[:, :pe]
        valid_e = torch.gather(~ctx_mask, 1, order_e)
        xe = torch.gather(local_features, 1, order_e[..., None].expand(-1, -1, de))
        projected = self.encoder_to_decoder_mapper(self.encoder(xe, key_padding_mask=~valid_e))

        # scatter into the mask-token canvas (invalid slots to row t, which
        # is dropped), add decoder positions
        dd = projected.shape[-1]
        canvas = self.mask_token.to(projected.dtype).expand(b, t + 1, dd)
        index = torch.where(valid_e, order_e, t)[..., None].expand(-1, -1, dd)
        canvas = canvas.scatter(1, index, projected)[:, :t]
        dec_in = canvas + self.pos_encoding_decoder.to(canvas.dtype)

        # decoder on the packed context ∪ group targets, targets first
        visible_d = ~ctx_and_target_mask
        is_target = visible_d & ctx_mask[:, None, :]
        rank = torch.where(is_target, 0, torch.where(visible_d, 1, 2)).to(torch.int8)
        order_d = torch.argsort(rank, dim=-1, stable=True)[..., :pd]  # (B, N, Pd)
        valid_d = torch.gather(visible_d, 2, order_d)
        dec_g = torch.gather(dec_in, 1, order_d.reshape(b, n * pd, 1).expand(-1, -1, dd))
        dec_out = self.decoder(dec_g.reshape(b * n, pd, dd),
                               key_padding_mask=(~valid_d).reshape(b * n, pd))
        return self.decoder_to_encoder_mapper(dec_out), order_d, valid_d

    def packed_prediction_loss(self, local_features, ctx_mask, ctx_and_target_mask,
                               targets, target_masks, return_terms: bool = False):
        """The masked MSE in packed space: teacher targets are gathered into
        the pack instead of predictions scattered out of it. The
        denominator is the full target count, as the reference's.
        ``return_terms`` returns (numerator, denominator) for exact
        accumulation over microbatches."""
        preds_p, order_d, valid_d = self._packed_predictions(
            local_features, ctx_mask, ctx_and_target_mask)
        b, n, pd = order_d.shape
        d = targets.shape[-1]
        tgt_p = torch.gather(targets, 1, order_d.reshape(b, n * pd, 1).expand(-1, -1, d))
        w_p = torch.gather(target_masks, 2, order_d) & valid_d
        diff = preds_p.reshape(b, n, pd, -1).float() - tgt_p.reshape(b, n, pd, d).float()
        num = (diff.square().mean(dim=-1) * w_p.float()).sum()
        den = target_masks.float().sum()
        if return_terms:
            return num, den
        return num / (den + 1e-8)

    # ------------------------------------------------------------ teacher

    def teacher_forward(self, local_features: torch.Tensor,
                        encoder: Optional[TransformerEncoder] = None) -> torch.Tensor:
        """Targets: the last k raw layer outputs of ``encoder`` (the EMA
        teacher; this model's encoder by default), no mask and no final
        norm, each instance-normed per (layer, sample) over (T, D) with the
        biased variance and rsqrt(var + 1e-5) in f32, then averaged."""
        k = self.config.average_top_k_layers
        outs = (encoder or self.encoder).layer_outputs(local_features)[-k:]
        if k <= 1:
            return outs[-1]
        acc = None
        for x in outs:
            x32 = x.float()
            mean = x32.mean(dim=(1, 2), keepdim=True)
            var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
            normed = (x32 - mean) * torch.rsqrt(var + 1e-5)
            acc = normed if acc is None else acc + normed
        return acc / k


def masked_prediction_loss(preds: torch.Tensor, targets: torch.Tensor,
                           target_indices: torch.Tensor, return_terms: bool = False):
    """MSE over target positions in f32: per-position mean over D, weighted
    by the (B, N, T) target mask, normalised by its count. preds
    (B, N, T, D), targets (B, T, D)."""
    per_t = (preds.float() - targets.float()[:, None]).square().mean(dim=-1)
    w = target_indices.float()
    num, den = (per_t * w).sum(), w.sum()
    if return_terms:
        return num, den
    return num / (den + 1e-8)
