"""WavJEPA model: configuration and the encoder side used for inference.

Counterpart of ``wavjepa_tpu/models/jepa.py``. ``JEPAConfig`` is carried
over whole, so configurations round-trip between the two packages;
``JEPA`` holds the path that serves: conv frontend → feature LayerNorm
(eps 1e-5) → 512→768 mapper → fixed sin-cos positions added in the
activation dtype → post-norm encoder. The decoder, the mask token and the
student/teacher passes belong to the training path, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from wavjepa_tpu_torch.ops.conv_frontend import (
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


class JEPA(nn.Module):
    """The encoder side of WavJEPA, under the reference's module names."""

    def __init__(self, config: JEPAConfig):
        super().__init__()
        cfg = config
        if cfg.extractor != "conv":
            raise NotImplementedError(f"extractor {cfg.extractor!r} has no port yet")
        check_attn_impl(cfg.attn_impl)
        self.config = cfg
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
        )
        # fixed table, not a parameter: derived from the config, not stored
        self.register_buffer(
            "pos_encoding_encoder",
            torch.from_numpy(cfg.pos_table(cfg.encoder_dim)),
            persistent=False,
        )

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
