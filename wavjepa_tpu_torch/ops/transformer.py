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
float32; GELU is exact, in the compute dtype. Each residual add goes into
the norm after it (``norm1(x, attn_out)``), which is one kernel on the card
(``ops/layer_norm.py``).

Tensor parallelism (``model_parallel`` = mp > 1, in the layout of
``parallel/mesh.init_layout``): a block holds its rank's H/mp heads (the q,
k and v rows of ``in_proj`` for them, and their columns of ``out_proj``)
and mlp_dim/mp hidden units (rows of ``linear1``, columns of ``linear2``),
the shards ``parallel/mesh.shard_params`` cuts. Two collectives a
sub-block, Megatron's: ``to_model_parallel`` (identity forward; the
gradient all-reduced over the tensor-parallel group backward) before each
column-split product, and ``from_model_parallel`` (the partial outputs
all-reduced forward; identity backward) after each row-split one, after
which ``out_proj.bias`` and ``linear2.bias`` are added whole, so that their
gradients, as every replicated leaf's, are the same on every rank of the
group. In bf16 each rank's partial output is rounded before the sum, so a
bf16 step at mp 2 is not bit-equal to one at mp 1; in f32 they agree to
rounding. At mp 1 a block is the plain module: no collective, no copy.

Recomputation (``remat``, ``ops/remat.py``), as the JAX package's
``nn.remat`` of each layer with ``save_only_these_names("attn_out")``: a
layer keeps its input and ``attn_out`` (``self_attn``'s output after the
output projection) and replays the rest in the backward, as two regions,
``self_attn`` and norm1 → MLP → norm2. The flash forward (or the fused
block's) therefore runs once more a layer in the backward. The JAX
package's ``remat_save_probs`` also keeps the (B, H, T, T) probabilities,
which the port's kernels never form; here it means that the attention core
is not replayed: ``self_attn`` runs outside the replayed regions and keeps
what its ``autograd.Function`` saves (q, k, v, the mask and the row
statistics; the fused block its inputs), so that the backward launches no
attention forward, at (B, T, 4·D) more of kept activations a layer
instead of the JAX package's (B, H, T, T). At ``model_parallel`` > 1 the
replay of norm1 → MLP → norm2 issues its forward all-reduce again in the
backward, as Megatron's recomputation does; every rank replays the same
layers in the same order, so the collectives stay matched.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from wavjepa_tpu_torch.ops.flash_attention import flash_attention
from wavjepa_tpu_torch.ops.fused_attention_block import fused_self_attention
from wavjepa_tpu_torch.ops.layer_norm import layer_norm32
from wavjepa_tpu_torch.ops.remat import remat
from wavjepa_tpu_torch.parallel.mesh import model_group, model_process_group

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


def _all_reduce_model_parallel(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` in place over this rank's tensor-parallel group, in its own
    dtype and on its own device: a backend that does not take them raises
    (no cast to another dtype on one backend and not on another)."""
    try:
        dist.all_reduce(t, group=model_process_group())
    except RuntimeError as e:
        raise RuntimeError(f"tensor-parallel all-reduce of a {t.dtype} tensor on {t.device} "
                           f"failed ({dist.get_backend(model_process_group())}): {e}") from e
    return t


class _ToModelParallel(torch.autograd.Function):
    """Identity forward; the gradient summed over the tensor-parallel group
    backward (each rank's slice of a column-split product gives a part of
    its input's gradient)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_model_parallel(g.clone(memory_format=torch.contiguous_format))


class _FromModelParallel(torch.autograd.Function):
    """The partial outputs of a row-split product summed over the
    tensor-parallel group forward; identity backward (every rank's output,
    and so its gradient, is the whole). ``torch.distributed.nn``'s
    all_reduce would sum the gradient as well, which multiplies it by the
    group's size."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_model_parallel(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g


def to_model_parallel(x: torch.Tensor) -> torch.Tensor:
    return _ToModelParallel.apply(x)


def from_model_parallel(x: torch.Tensor) -> torch.Tensor:
    return _FromModelParallel.apply(x)


def check_model_parallel(mp: int, **counts: int) -> None:
    """Raise where ``mp`` does not divide a count the blocks split (heads,
    mlp_dim), naming it, or where this rank's tensor-parallel group is not
    of ``mp`` ranks (``parallel/mesh.init_layout``)."""
    for name, n in counts.items():
        if n % mp:
            raise ValueError(f"trainer.model_parallel={mp} does not divide {name}={n}")
    if mp > 1 and model_group()[1] != mp:
        raise ValueError(f"model_parallel={mp} needs a tensor-parallel group of {mp} ranks "
                         f"(parallel/mesh.init_layout); this rank's has {model_group()[1]}")


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
    dtype, returned in ``dtype``; ``residual``, when given, is added to x
    first, rounded to x's dtype as the add rounds it
    (``ops/layer_norm.layer_norm32``: the kernel on the card)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return layer_norm32(x, self.weight, self.bias, self.eps, self.dtype, residual)


class MultiHeadSelfAttention(nn.Module):
    """Packed-QKV multi-head self-attention with a key-padding mask.

    ``in_proj_weight`` is (3A, D): q | k | v along the output, each split
    head-major, as torch's ``nn.MultiheadAttention`` packs it, and
    ``out_proj.weight`` (D, A), where A = D at ``model_parallel`` 1 and
    D/mp (this rank's heads) above. With ``attn_impl="fused_block"`` the
    projections and attention run as one fused block on the same
    parameters."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", model_parallel: int = 1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.model_parallel = model_parallel
        self.local_heads = num_heads // model_parallel
        self.dtype = dtype
        self.attn_impl = check_attn_impl(attn_impl)
        width = embed_dim // model_parallel  # A, this rank's heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, embed_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        h, a = self.local_heads, self.in_proj_weight.shape[0] // 3
        split = self.model_parallel > 1
        if key_padding_mask is None:
            key_padding_mask = torch.zeros((b, t), dtype=torch.bool, device=x.device)
        if split:
            x = to_model_parallel(x)
        w_out = self.out_proj.weight.to(self.dtype)
        b_out = None if split else self.out_proj.bias.to(self.dtype)  # whole, after the sum
        if self.attn_impl == "fused_block":  # the parameters as they lie
            out = fused_self_attention(
                x.to(self.dtype), self.in_proj_weight.to(self.dtype),
                self.in_proj_bias.to(self.dtype), w_out, b_out, key_padding_mask.contiguous(), h,
            )
        else:
            qkv = F.linear(
                x.to(self.dtype), self.in_proj_weight.to(self.dtype),
                self.in_proj_bias.to(self.dtype),
            )
            q, k, v = (
                part.reshape(b, t, h, a // h).transpose(1, 2).contiguous()
                for part in qkv.split(a, dim=-1)
            )
            out = flash_attention(q, k, v, key_padding_mask.contiguous())
            out = F.linear(out.transpose(1, 2).reshape(b, t, a), w_out, b_out)
        if split:
            out = from_model_parallel(out) + self.out_proj.bias.to(self.dtype)
        return out


class TransformerEncoderLayer(nn.Module):
    """Post-norm block: x = norm1(x + SA(x)); x = norm2(x + MLP(x)). At
    ``model_parallel`` mp > 1 it holds H/mp heads and mlp_dim/mp hidden
    units, and refuses counts that mp does not divide. ``remat`` and
    ``remat_save_probs``: see the module docstring."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 layer_norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", model_parallel: int = 1, remat: bool = False,
                 remat_save_probs: bool = False):
        super().__init__()
        check_model_parallel(model_parallel, heads=num_heads, mlp_dim=mlp_dim)
        self.model_parallel = model_parallel
        self.remat = remat
        self.remat_save_probs = remat_save_probs
        self.self_attn = MultiHeadSelfAttention(embed_dim, num_heads, dtype, attn_impl,
                                                model_parallel)
        self.linear1 = Linear(embed_dim, mlp_dim // model_parallel, dtype=dtype)
        self.linear2 = Linear(mlp_dim // model_parallel, embed_dim, dtype=dtype)
        self.norm1 = LayerNorm32(embed_dim, layer_norm_eps, dtype)
        self.norm2 = LayerNorm32(embed_dim, layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.remat and not self.remat_save_probs:
            attn_out = remat(self.self_attn, x, key_padding_mask)
        else:
            attn_out = self.self_attn(x, key_padding_mask)
        if self.remat:
            return remat(self._after_attention, x, attn_out)
        return self._after_attention(x, attn_out)

    def _after_attention(self, x: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x, attn_out)
        if self.model_parallel == 1:
            h = self.linear2(F.gelu(self.linear1(x)))
        else:
            lin2 = self.linear2
            h = F.gelu(self.linear1(to_model_parallel(x))).to(lin2.dtype)
            h = from_model_parallel(F.linear(h, lin2.weight.to(lin2.dtype))) + lin2.bias.to(
                lin2.dtype)
        return self.norm2(x, h)


class TransformerEncoder(nn.Module):
    """Stack of post-norm layers plus a final LayerNorm.

    ``forward`` returns the normed output; ``layer_outputs`` returns every
    layer's output before the final norm (the teacher's targets). ``remat``
    replays each layer in the backward (see the module docstring)."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int, mlp_dim: int,
                 layer_norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", model_parallel: int = 1, remat: bool = False,
                 remat_save_probs: bool = False):
        super().__init__()
        self.model_parallel = model_parallel
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, mlp_dim, layer_norm_eps, dtype,
                                    attn_impl, model_parallel, remat, remat_save_probs)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm32(embed_dim, layer_norm_eps, dtype)

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax defaults: lecun-normal projections, zero biases, unit norms.
        A tensor-parallel stack is not initialised itself: the whole one
        is, and each rank takes its shard (``parallel/mesh.sharded``), so
        that every ``model_parallel`` starts from the same weights."""
        if self.model_parallel != 1:
            raise ValueError("initialise the whole model and shard it (parallel/mesh.sharded)")
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
