"""Post-norm transformer encoder with packed-QKV self-attention.

Counterpart of ``wavjepa_tpu/ops/transformer.py``. Module and parameter
names are the reference's torch names (``self_attn.in_proj_weight``,
``self_attn.out_proj``, ``linear1``, ``linear2``, ``norm1``, ``norm2``, and
the encoder's final ``norm``), so a reference ``state_dict`` loads as is.
The modules are written here rather than taken from ``torch.nn``: the fast
paths of ``nn.MultiheadAttention`` and ``nn.TransformerEncoderLayer`` call
library attention kernels, and the port's attention is its own kernel
(``ops/flash_attention.py``), or, with ``attn_impl="fused_block"``, the
projection-fused block (``ops/fused_attention_block.py``), which takes the
same parameters.

Mixed precision follows flax: parameters stay float32 and are cast to the
compute ``dtype`` (bfloat16 on the card) at use; LayerNorm and softmax run in
float32; GELU is exact, in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wavjepa_tpu_torch.ops.flash_attention import flash_attention
from wavjepa_tpu_torch.ops.fused_attention_block import fused_self_attention

# every attn_impl the JAX package names; all but "fused_block" mean the
# flash-attention kernel on CUDA tensors and its plain version on the CPU;
# "fused_block" means the projection-fused block's kernels and plain versions
ATTN_IMPLS = ("auto", "einsum", "einsum_bthd", "sdpa", "pallas", "fused_block")


def check_attn_impl(impl: str) -> str:
    """``JEPAConfig.attn_impl`` as the port reads it (see ATTN_IMPLS)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}")
    return impl


def key_padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool (True = ignore key) → (B, 1, 1, T) f32 additive bias of
    −0.7·f32max: finite after a cast to bf16, and exp of it underflows to
    exactly 0, so a fully masked row is uniform rather than NaN."""
    neg = torch.full((), -0.7 * torch.finfo(torch.float32).max, device=key_padding_mask.device)
    return torch.where(key_padding_mask[:, None, None, :], neg, torch.zeros_like(neg))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The JAX package's einsum attention on (B, H, T, d): q scaled in its
    own dtype, logits in the io dtype plus the additive bias, f32 softmax.
    The port's layers use the kernel's semantics instead (f32 scores, scale
    on the scores); this is kept to compare the two."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.matmul(weights, v.to(dtype)).to(dtype)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default Dense init: truncated normal (±2σ) of variance
    1/fan_in, σ corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Linear(nn.Module):
    """``x @ weight.T + bias`` with float32 parameters cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm32(nn.Module):
    """LayerNorm over the last dim computed in float32 whatever the input
    dtype, returned in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class MultiHeadSelfAttention(nn.Module):
    """Packed-QKV multi-head self-attention with a key-padding mask.

    ``in_proj_weight`` is (3D, D): q | k | v along the output, each split
    head-major, as torch's ``nn.MultiheadAttention`` packs it. With
    ``attn_impl="fused_block"`` the projections and attention run as one
    fused block on the same parameters."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = check_attn_impl(attn_impl)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        if key_padding_mask is None:
            key_padding_mask = torch.zeros((b, t), dtype=torch.bool, device=x.device)
        if self.attn_impl == "fused_block":  # the parameters as they lie
            return fused_self_attention(
                x.to(self.dtype), self.in_proj_weight.to(self.dtype),
                self.in_proj_bias.to(self.dtype), self.out_proj.weight.to(self.dtype),
                self.out_proj.bias.to(self.dtype), key_padding_mask.contiguous(), h,
            )
        qkv = F.linear(
            x.to(self.dtype), self.in_proj_weight.to(self.dtype),
            self.in_proj_bias.to(self.dtype),
        )
        q, k, v = (
            a.reshape(b, t, h, d // h).transpose(1, 2).contiguous()
            for a in qkv.split(d, dim=-1)
        )
        out = flash_attention(q, k, v, key_padding_mask.contiguous())
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class TransformerEncoderLayer(nn.Module):
    """Post-norm block: x = norm1(x + SA(x)); x = norm2(x + MLP(x))."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 layer_norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(embed_dim, num_heads, dtype, attn_impl)
        self.linear1 = Linear(embed_dim, mlp_dim, dtype=dtype)
        self.linear2 = Linear(mlp_dim, embed_dim, dtype=dtype)
        self.norm1 = LayerNorm32(embed_dim, layer_norm_eps, dtype)
        self.norm2 = LayerNorm32(embed_dim, layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, key_padding_mask))
        h = self.linear2(F.gelu(self.linear1(x)))
        return self.norm2(x + h)


class TransformerEncoder(nn.Module):
    """Stack of post-norm layers plus a final LayerNorm.

    ``forward`` returns the normed output; ``layer_outputs`` returns every
    layer's output before the final norm (the teacher's targets)."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int, mlp_dim: int,
                 layer_norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, mlp_dim, layer_norm_eps, dtype,
                                    attn_impl)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm32(embed_dim, layer_norm_eps, dtype)

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax defaults: lecun-normal projections, zero biases, unit norms."""
        for layer in self.layers:
            attn = layer.self_attn
            _lecun_normal_(attn.in_proj_weight, attn.embed_dim, generator)
            for lin in (attn.out_proj, layer.linear1, layer.linear2):
                _lecun_normal_(lin.weight, lin.weight.shape[1], generator)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return self.norm(x)

    def layer_outputs(self, x: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
        outs = []
        for layer in self.layers:
            x = layer(x, key_padding_mask)
            outs.append(x)
        return outs
