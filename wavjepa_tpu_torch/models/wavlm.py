"""WavLM (Chen et al., "WavLM: Large-Scale Self-Supervised Pre-Training for
Full Stack Speech Processing", IEEE JSTSP 2022, arXiv:2110.13900) as the
port serves it: the encoder of ``microsoft/wavlm-large``, forward only.

The JAX package has no WavLM; this follows the published configuration
(``WavLMConfig`` holds its keys) and ``transformers``' ``WavLMModel`` in
eval mode, equation for equation:

  * the frontend: 7 convolutions without bias, each → LayerNorm over the
    channels → GELU (``ops/conv_frontend.py``'s "layer_norm" mode, its
    norms in float32), then LayerNorm(512) → Linear 512 → 1024;
  * the frames past an utterance's end zeroed, then the positional
    convolution (Conv1d 1024 → 1024, kernel 128, 16 groups, padding 64, its
    weight norm folded into one weight), the last frame dropped, GELU,
    added to its input;
  * 24 pre-norm layers: s = x + SA(LN1(x)); x' = s + FFN(LN2(s)); then a
    final LayerNorm. Each join of a residual and the norm after it is one
    kernel on the card (``ops/layer_norm.add_layer_norm32``), which writes
    the stream s beside the normed y;
  * the attention: softmax(q·kᵀ/8 + g[b, h, q]·E[b(k − q), h], masked keys)
    · v, with E the (320, H) bucket embedding that layer 0 holds and every
    layer uses, b the bucket of an offset (``relative_position_bucket``),
    and g each layer's gate from its normed input x̂ viewed per head:
    u = Linear(64 → 8)(x̂) summed in two groups of 4, a, c = sigmoid(u),
    g = a·(c·κ_h − 1) + 2. The gate's product is taken with the 8 rows
    summed into 2 first (the same linear map). The bias goes through
    ``ops/flash_attention.relbias_attention``: the ``relbias_flash`` kernel
    on the card, which reads a per-offset table built once a forward, and
    never the (B, H, T, T) bias.

Parameters stay float32 and are cast to ``dtype`` (bfloat16 on the card)
at use; norms run in float32. Names follow ``WavLMModel``'s, but for the
packed q | k | v projection (``attention.in_proj_weight``) and the folded
positional weight; ``api/convert.state_dict_from_hf_wavlm`` maps a
``transformers`` state dict onto them. Phases: spans ``wavlm.frontend``,
``wavlm.pos_conv`` and ``wavlm.encoder`` (``utils/profiling``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wavjepa_tpu_torch.ops.conv_frontend import ConvFeatureExtractor, conv_output_length
from wavjepa_tpu_torch.ops.flash_attention import relbias_attention, relbias_offsets
from wavjepa_tpu_torch.ops.layer_norm import add_layer_norm32
from wavjepa_tpu_torch.ops.transformer import LayerNorm32, Linear
from wavjepa_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """The architecture keys of ``microsoft/wavlm-large``'s config.json, by
    their published names and values, and how the port serves it."""

    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "layer"
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    do_stable_layer_norm: bool = True
    # serving
    sample_rate: int = 16000
    do_normalize: bool = True  # each utterance to zero mean and unit variance
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.feat_extract_norm != "layer" or not self.do_stable_layer_norm:
            raise ValueError("the port serves WavLM's pre-norm form with a LayerNorm frontend "
                             "(feat_extract_norm='layer', do_stable_layer_norm=True)")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible by "
                             f"{self.num_attention_heads} heads")

    @property
    def conv_spec(self) -> tuple:
        return tuple(zip(self.conv_dim, self.conv_kernel, self.conv_stride))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def frames(self, samples: int) -> int:
        """Frames the frontend gives an utterance of ``samples``."""
        return conv_output_length(samples, self.conv_spec)


def relative_position_bucket(offsets: torch.Tensor, num_buckets: int = 320,
                             max_distance: int = 800) -> torch.Tensor:
    """WavLM's bucket of each offset r = k − q: with nb = num_buckets / 2
    and e = nb / 2, nb·[r > 0] + (|r| below e, else min(nb − 1, e +
    ⌊ln(|r|/e) / ln(max_distance/e) · (nb − e)⌋)), the log in float32, as
    ``WavLMAttention._relative_positions_bucket`` takes it."""
    nb = num_buckets // 2
    exact = nb // 2
    out = (offsets > 0).long() * nb
    r = offsets.abs()
    large = torch.log(r.float() / exact) / math.log(max_distance / exact) * (nb - exact)
    large = torch.clamp((exact + large).long(), max=nb - 1)
    return out + torch.where(r < exact, r, large)


class _Embedding(nn.Module):
    """The bucket embedding's table, under ``rel_attn_embed.weight``."""

    def __init__(self, rows: int, cols: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(rows, cols))


class WavLMAttention(nn.Module):
    """Packed-QKV self-attention with the gated relative-position bias;
    layer 0's holds the bucket embedding (``rel_attn_embed``)."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.dtype = h, cfg.dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d, dtype=cfg.dtype)
        self.gru_rel_pos_linear = Linear(cfg.head_dim, 8, dtype=cfg.dtype)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = _Embedding(cfg.num_buckets, h)

    def gate(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T, D) normed input → the (B, H, T) f32 gate g."""
        b, t, d = y.shape
        lin = self.gru_rel_pos_linear
        w = lin.weight.reshape(2, 4, -1).sum(1)  # the 8 outputs summed in two groups of 4
        u = F.linear(y.reshape(b, t, self.heads, -1), w.to(self.dtype),
                     lin.bias.reshape(2, 4).sum(1).to(self.dtype))
        ac = torch.sigmoid(u.float()).permute(0, 2, 1, 3)  # (B, H, T, 2)
        kappa = self.gru_rel_pos_const.reshape(1, self.heads, 1)
        return (ac[..., 0] * (ac[..., 1] * kappa - 1.0) + 2.0).contiguous()

    def forward(self, y: torch.Tensor, mask: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        b, t, d = y.shape
        qkv = F.linear(y, self.in_proj_weight.to(self.dtype), self.in_proj_bias.to(self.dtype))
        q, k, v = (part.reshape(b, t, self.heads, -1).transpose(1, 2).contiguous()
                   for part in qkv.split(d, dim=-1))
        o = relbias_attention(q, k, v, mask, table, self.gate(y))
        return self.out_proj(o.transpose(1, 2).reshape(b, t, d))


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMLayer(nn.Module):
    """A pre-norm layer: ``layer_norm`` → attention, ``final_layer_norm`` →
    feed-forward. The stack joins each sublayer's output to the stream in
    the norm that follows it."""

    def __init__(self, cfg: WavLMConfig, index: int):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = WavLMAttention(cfg, has_relative_position_bias=index == 0)
        self.layer_norm = LayerNorm32(d, eps, cfg.dtype)
        self.feed_forward = WavLMFeedForward(cfg)
        self.final_layer_norm = LayerNorm32(d, eps, cfg.dtype)


class _PosConv(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        d, g = cfg.hidden_size, cfg.num_conv_pos_embedding_groups
        self.weight = nn.Parameter(torch.empty(d, d // g, cfg.num_conv_pos_embeddings))
        self.bias = nn.Parameter(torch.zeros(d))


class _PosConvEmbed(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.conv = _PosConv(cfg)


class WavLMEncoder(nn.Module):
    """Positional convolution, the pre-norm layers and the final norm."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.pos_conv_embed = _PosConvEmbed(cfg)
        self.layers = nn.ModuleList(WavLMLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.layer_norm = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps, torch.float32)

    def position(self, x: torch.Tensor) -> torch.Tensor:
        """x + GELU(pos_conv(x)) with the conv's last frame dropped."""
        cfg, conv = self.cfg, self.pos_conv_embed.conv
        y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                     padding=cfg.num_conv_pos_embeddings // 2,
                     groups=cfg.num_conv_pos_embedding_groups)
        if cfg.num_conv_pos_embeddings % 2 == 0:
            y = y[..., :-1]
        return x + F.gelu(y).transpose(1, 2)

    def bias_table(self, t: int, device) -> torch.Tensor:
        """The per-offset table the attention reads, (H, 256·⌈t/128⌉) f32:
        layer 0's embedding of each offset's bucket."""
        cfg = self.cfg
        buckets = relative_position_bucket(relbias_offsets(t, device), cfg.num_buckets,
                                           cfg.max_bucket_distance)
        embed = self.layers[0].attention.rel_attn_embed.weight
        return embed.float()[buckets].t().contiguous()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, T, D) projected features, zero at padded frames, (B, T) bool
        mask (True = padding) → (B, T, D) float32 after the final norm."""
        with span("wavlm.pos_conv"):
            x = self.position(x)
        with span("wavlm.encoder"):
            table = self.bias_table(x.shape[1], x.device)
            layers = self.layers
            s, y = x, layers[0].layer_norm(x)
            for i, layer in enumerate(layers):
                a = layer.attention(y, mask, table)
                n = layer.final_layer_norm
                y, s = add_layer_norm32(a, s, n.weight, n.bias, n.eps, n.dtype)
                h = layer.feed_forward(y)
                if i + 1 < len(layers):
                    n = layers[i + 1].layer_norm
                    y, s = add_layer_norm32(h, s, n.weight, n.bias, n.eps, n.dtype)
            return self.layer_norm(h, s)  # the stream's end: the final norm, in f32


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = LayerNorm32(cfg.conv_dim[-1], cfg.layer_norm_eps, cfg.dtype)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class WavLM(nn.Module):
    """WavLM's encoder: (B, samples) audio and each utterance's samples →
    (B, T, D) float32 frames and the (B, T) padding mask."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.config = cfg
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_spec, 1, "layer_norm",
                                                      cfg.conv_bias, cfg.dtype)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = WavLMEncoder(cfg)

    def padding_mask(self, lengths: torch.Tensor, frames: int) -> torch.Tensor:
        """(B, frames) bool, True at frames past each utterance's end, from
        its length in samples (the frontend's output-length formula)."""
        valid = lengths.clone()
        for _, k, s in self.config.conv_spec:
            valid = torch.div(valid - k, s, rounding_mode="floor") + 1
        return torch.arange(frames, device=lengths.device)[None, :] >= valid[:, None]

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        with span("wavlm.frontend"):
            feats = self.feature_extractor(audio.to(self.config.dtype))
            mask = self.padding_mask(lengths, feats.shape[1])
            x = self.feature_projection(feats).masked_fill(mask[..., None], 0.0)
        return self.encoder(x, mask), mask

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded weights for tests and serving without a checkpoint:
        kaiming-normal convolutions, lecun-normal products (the positional
        convolution's fan-in its group's 64 channels × 128 taps), a
        standard-normal bucket embedding, gate constants in [0.5, 1.5],
        unit norms and zero biases."""
        self.feature_extractor.init_parameters(generator)
        for name, p in self.named_parameters():
            if name.endswith("weight") and p.dim() == 2 and "rel_attn_embed" not in name:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif name.endswith("pos_conv_embed.conv.weight"):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1] * p.shape[2]), generator=generator)
            elif name.endswith("rel_attn_embed.weight"):
                p.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("gru_rel_pos_const"):
                p.uniform_(0.5, 1.5, generator=generator)
