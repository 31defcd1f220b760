"""Wav2Vec2-style stacked temporal-convolution waveform encoder.

Counterpart of ``wavjepa_tpu/ops/conv_frontend.py:ConvFeatureExtractor`` and
``ConvChannelFeatureExtractor`` (one such stack per audio channel, or one
shared).
Each block is Conv1d (VALID, no dilation) → {GroupNorm(C, C) on block 0 in
"default" mode | channel LayerNorm on every block in "layer_norm" mode |
nothing} → exact GELU. Norm statistics and affine run in float32 (eps 1e-5);
the convolution and GELU run in the compute dtype (bfloat16 on the card).
Parameters stay float32 and are cast at use.

Module names follow the reference's ``nn.Sequential`` block layout, so a
reference ``state_dict`` loads as is: ``cnn.{i}.0`` is the convolution,
``cnn.{i}.2`` the GroupNorm ("default") or ``cnn.{i}.2.1`` the LayerNorm
("layer_norm"). The per-channel frontend keeps the reference's
``cnns.{c}.{i}`` (``cnns.0`` when the channels share weights).

``remat`` replays each block on its own in the backward (``ops/remat.py``),
as the JAX package's ``nn.remat(ConvBlock)``: each block keeps its input,
never the stack's temporaries, and a stack is never replayed whole (whose
replay would hold several (B, 512, T_i) f32 temporaries live at once).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wavjepa_tpu_torch.ops.remat import remat as _remat

ConvSpec = Sequence[tuple[int, int, int]]  # (out_dim, kernel, stride) per layer

WAVJEPA_CONV_SPEC: ConvSpec = tuple([(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)])
WAV2VEC2_CONV_SPEC: ConvSpec = tuple(
    [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
)


def conv_output_length(time: int, spec: ConvSpec) -> int:
    """Output frames for an input of ``time`` samples (VALID, no dilation)."""
    for _, k, s in spec:
        time = (time - k) // s + 1
        if time <= 0:
            raise ValueError(f"input too short for conv spec at layer k={k},s={s}")
    return time


def conv_receptive_fields(spec: ConvSpec) -> list[int]:
    """Receptive field in samples at each layer boundary, input first."""
    rf = 1
    fields = [rf]
    for _, width, stride in reversed(list(spec)):
        rf = (rf - 1) * stride + width
        fields.append(rf)
    return list(reversed(fields))


class _Conv(nn.Module):
    def __init__(self, in_c: int, out_c: int, kernel: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_c, in_c, kernel))
        self.bias = nn.Parameter(torch.zeros(out_c)) if bias else None


class _ChannelAffine(nn.Module):
    """Float32 per-channel scale and shift (the norm's parameters)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


def _normalize(y: torch.Tensor, norm: _ChannelAffine, dim: int) -> torch.Tensor:
    """f32 (x − mean)·rsqrt(var + 1e-5)·w + b over ``dim`` of (B, C, T)."""
    y32 = y.float()
    mean = y32.mean(dim=dim, keepdim=True)
    var = (y32 - mean).square().mean(dim=dim, keepdim=True)
    y32 = (y32 - mean) * torch.rsqrt(var + 1e-5)
    return y32 * norm.weight[None, :, None] + norm.bias[None, :, None]


class ConvBlock(nn.Module):
    """Conv1d → {GroupNorm | LayerNorm | none} → exact GELU on (B, C, T)."""

    def __init__(self, in_c: int, out_dim: int, kernel: int, stride: int,
                 norm: str = "none", use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.norm = norm
        self.add_module("0", _Conv(in_c, out_dim, kernel, use_bias))
        if norm == "group":
            self.add_module("2", _ChannelAffine(out_dim))
        elif norm == "layer":
            # reference: Sequential(rearrange, LayerNorm, rearrange)
            wrapper = nn.Module()
            wrapper.add_module("1", _ChannelAffine(out_dim))
            self.add_module("2", wrapper)
        elif norm != "none":
            raise ValueError(f"unknown norm {norm!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        conv = getattr(self, "0")
        bias = None if conv.bias is None else conv.bias.to(dtype)
        y = F.conv1d(x.to(dtype), conv.weight.to(dtype), bias, stride=self.stride)
        if self.norm == "group":  # per-(sample, channel) stats over time
            y = _normalize(y, getattr(self, "2"), dim=-1)
        elif self.norm == "layer":  # over channels at each step
            y = _normalize(y, getattr(getattr(self, "2"), "1"), dim=1)
        return F.gelu(y.to(dtype))


def _conv_blocks(conv_spec: ConvSpec, in_channels: int, mode: str, conv_bias: bool,
                 dtype: torch.dtype) -> nn.ModuleList:
    """The blocks of one stack: GroupNorm on block 0 ("default") or a
    LayerNorm on every block ("layer_norm")."""
    if mode not in ("default", "layer_norm"):
        raise ValueError(f"unknown extractor mode {mode!r}")
    blocks = []
    in_d = in_channels
    for i, (dim, k, s) in enumerate(conv_spec):
        norm = "layer" if mode == "layer_norm" else ("group" if i == 0 else "none")
        blocks.append(ConvBlock(in_d, dim, k, s, norm=norm, use_bias=conv_bias, dtype=dtype))
        in_d = dim
    return nn.ModuleList(blocks)


@torch.no_grad()
def _kaiming_init(blocks: nn.ModuleList, generator: Optional[torch.Generator]) -> None:
    """Kaiming-normal convolutions (fan_in, leaky_relu a=0.01 gain), as the
    JAX package initialises them."""
    gain = math.sqrt(2.0 / (1.0 + 0.01**2))
    for block in blocks:
        w = getattr(block, "0").weight
        w.normal_(0.0, gain / math.sqrt(w.shape[1] * w.shape[2]), generator=generator)


def _run(blocks: nn.ModuleList, x: torch.Tensor, remat: bool) -> torch.Tensor:
    for block in blocks:
        x = _remat(block, x) if remat else block(x)
    return x


class ConvFeatureExtractor(nn.Module):
    """(B, C_in, T) or (B, T) waveforms → (B, T', embed_dim) frames."""

    def __init__(self, conv_spec: ConvSpec = WAVJEPA_CONV_SPEC, in_channels: int = 1,
                 mode: str = "default", conv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.conv_spec = tuple(tuple(layer) for layer in conv_spec)
        self.remat = remat
        self.cnn = _conv_blocks(self.conv_spec, in_channels, mode, conv_bias, dtype)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _kaiming_init(self.cnn, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            x = x[:, None, :]
        return _run(self.cnn, x, self.remat).transpose(1, 2)


class ConvChannelFeatureExtractor(nn.Module):
    """Per-channel frontend for multichannel (binaural, ambisonic) scenes:
    (B, C, T) → (B, C·T', embed_dim). Each channel runs through its own
    stack, or all through one (``share_weights``, with the channels folded
    into the batch); the tokens are channel-major, [c0t0, c0t1, …, c1t0, …]."""

    def __init__(self, conv_spec: ConvSpec = WAVJEPA_CONV_SPEC, in_channels: int = 2,
                 mode: str = "default", conv_bias: bool = False,
                 share_weights: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.conv_spec = tuple(tuple(layer) for layer in conv_spec)
        self.remat = remat
        self.in_channels = in_channels
        self.share_weights = share_weights
        self.cnns = nn.ModuleList(
            _conv_blocks(self.conv_spec, 1, mode, conv_bias, dtype)
            for _ in range(1 if share_weights else in_channels)
        )

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for blocks in self.cnns:
            _kaiming_init(blocks, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        if self.share_weights:
            y = _run(self.cnns[0], x.reshape(b * c, 1, t), self.remat)  # (B·C, E, T')
            y = y.reshape(b, c, y.shape[1], y.shape[2])
        else:
            y = torch.stack([_run(blocks, x[:, ch:ch + 1], self.remat) for ch, blocks in
                             enumerate(self.cnns)], dim=1)  # (B, C, E, T')
        return y.transpose(2, 3).reshape(b, c * y.shape[3], y.shape[2])
