"""Projection-fused attention block, forward and backward: hand-written
Hopper kernels and their plain PyTorch versions.

Counterpart of ``wavjepa_tpu/ops/fused_attention_block.py``:
``fused_attention_block`` and its custom VJP (``_fwd_kernel`` and
``_bwd_kernel``), which compute OutProj(MHSA(QKVProj(x))) per batch row.
The kernels are ``csrc/fused_attention_block_fwd.cu`` and
``csrc/fused_attention_block_bwd.cu`` (their products in
``csrc/hopper_gemm.cuh``); their sources say what bounds them on the card
and how their design answers that.

Two entries. ``fused_self_attention(x, in_proj_weight, in_proj_bias,
out_proj_weight, out_proj_bias, mask, heads)`` takes the torch module's
parameters as they lie, which are the kernels' layouts: the transformer
calls it. ``fused_attention_block(x, wqkv, bqkv, wo, bo, mask)`` keeps the
JAX signature (``interpret`` dropped) and layouts: x (B, T, D); wqkv
(H, D, 3·hd) with column blocks [Wq_h | Wk_h | Wv_h]; bqkv (H, 1, 3·hd); wo
(H, hd, D); bo (1, D); mask (B, T) bool, True = ignore that key. It unpacks
them (views) and calls the first; ``pack_weights`` goes the other way.

The heads may be a subset: under tensor parallelism a rank's block holds
H/mp of them, an attention width A = H·hd below the model width D, so that
in_proj_weight is (3A, D), in_proj_bias (3A,) and out_proj.weight (D, A),
and the products are (B·T × D)·(D × 3A) and (B·T × A)·(A × D). There the
output bias is left out (``out_proj_bias=None``): the transformer adds it
after the partial outputs are summed over the ranks. When
a gradient is wanted both go through ``FusedAttentionBlock``, a
``torch.autograd.Function`` that saves only its inputs and whose backward
has ``_bwd_kernel``'s maths on both devices: a fully masked row (uniform P)
keeps a non-zero dS, where autograd through ``masked_fill`` would zero it. A
CUDA tensor always goes to the kernels (bf16 or f32, head_dim 32 or 64;
anything else raises); a CPU tensor goes to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from wavjepa_tpu_torch.ops import _build
from wavjepa_tpu_torch.utils.profiling import launch_counted

# −0.7·f32max, as the JAX kernel: finite, so a fully masked row is uniform
NEG_BIG = -0.7 * torch.finfo(torch.float32).max

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_TILE = 128  # rows and columns of a weight gradient a kernel tile owns (bf16)


def pack_weights(
    in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
    out_proj_weight: torch.Tensor, heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The port's (3A, D) packed-QKV weight (rows q | k | v, each head-major),
    (3A,) bias and (D, A) ``out_proj.weight`` → the JAX package's per-head
    layouts ((H, D, 3·hd), (H, 1, 3·hd), (H, hd, D)), A = H·hd. Reshapes and
    permutes only, so autograd carries the gradients back to the
    parameters."""
    d = in_proj_weight.shape[1]
    hd = in_proj_weight.shape[0] // 3 // heads
    wqkv = in_proj_weight.reshape(3, heads, hd, d).permute(1, 3, 0, 2).reshape(heads, d, 3 * hd)
    bqkv = in_proj_bias.reshape(3, heads, 1, hd).permute(1, 2, 0, 3).reshape(heads, 1, 3 * hd)
    wo = out_proj_weight.t().reshape(heads, hd, d)
    return wqkv, bqkv, wo


def _qkv_heads(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 3·hd): x·Wqkv[h] summed in f32 plus bqkv[h] in f32, rounded
    to x's dtype."""
    qkv = torch.einsum("btd,hdj->bhtj", x.float(), wqkv.float()) + bqkv.float()[None]
    return qkv.to(x.dtype)


def _probs(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32 softmax of d^-½·q·kᵀ (f32 scores), masked keys at NEG_BIG."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.softmax(s.masked_fill(mask[:, None, None, :], NEG_BIG), dim=-1)


def fused_attention_block_reference(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
    bo: torch.Tensor, mask: torch.Tensor,
) -> torch.Tensor:
    """Plain version of ``_fwd_kernel``: per head qkv rounded to x's dtype,
    f32 scores and softmax, P rounded, o_h = P·v_h summed in f32 and
    rounded, acc = Σ_h o_h·Wo[h] + bo in f32, rounded once (``bo`` None:
    no bias)."""
    hd = wqkv.shape[-1] // 3
    q, k, v = _qkv_heads(x, wqkv, bqkv).split(hd, dim=-1)
    p = _probs(q, k, mask).to(x.dtype)
    o = torch.matmul(p.float(), v.float()).to(x.dtype)
    acc = torch.einsum("bhti,hin->btn", o.float(), wo.float())
    return (acc if bo is None else acc + bo.float()).to(x.dtype)


def fused_attention_block_bwd_reference(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
    mask: torch.Tensor, g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain version of ``_bwd_kernel``, the forward recomputed from the
    inputs: dbo = Σ g; per head dWo[h] = o_hᵀ·g_lo, do_h = g_lo·Wo[h]ᵀ
    rounded, dv = P_loᵀ·do_h, dp = do_h·v_hᵀ, dS = P⊙(dp − rowsum(dp⊙P)) in
    f32 with no zeroing at masked keys, dq = d^-½·dS_lo·k_h, dk =
    d^-½·dS_loᵀ·q_h; dqkv_h = [dq | dk | dv] rounded to x's dtype, then
    dbqkv[h] = Σ dqkv_h, dWqkv[h] = xᵀ·dqkv_h and dx = Σ_h dqkv_h·Wqkv[h]ᵀ
    in f32, rounded once. ``_lo`` is rounded to x's dtype. Returns dx in x's
    dtype and (dwqkv, dbqkv, dwo, dbo) in f32."""
    dt = x.dtype
    hd = wqkv.shape[-1] // 3
    scale = 1.0 / math.sqrt(hd)
    q, k, v = _qkv_heads(x, wqkv, bqkv).split(hd, dim=-1)
    p = _probs(q, k, mask)
    p_lo = p.to(dt).float()
    o = torch.matmul(p_lo, v.float()).to(dt).float()
    g_lo = g.to(dt).float()
    dbo = g.float().sum(dim=(0, 1))[None]
    dwo = torch.einsum("bhti,btn->hin", o, g_lo)
    do = torch.einsum("btn,hin->bhti", g_lo, wo.float()).to(dt).float()
    dv = torch.matmul(p_lo.transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds_lo = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = scale * torch.matmul(ds_lo, k.float())
    dk = scale * torch.matmul(ds_lo.transpose(-1, -2), q.float())
    dqkv = torch.cat([dq, dk, dv], dim=-1).to(dt).float()  # (B, H, T, 3·hd)
    dbqkv = dqkv.sum(dim=(0, 2))[:, None]
    dwqkv = torch.einsum("btd,bhtj->hdj", x.float(), dqkv)
    dx = torch.einsum("bhtj,hdj->btd", dqkv, wqkv.float()).to(dt)
    return dx, dwqkv, dbqkv, dwo, dbo


def _check(x, wqkv, bqkv, wo, mask, bo=None) -> None:
    if x.dim() != 3 or wqkv.dim() != 3:
        raise ValueError(f"x must be (B, T, D) and wqkv (H, D, 3·hd), got "
                         f"{tuple(x.shape)} and {tuple(wqkv.shape)}")
    b, t, d = x.shape
    heads, hd = wqkv.shape[0], wqkv.shape[2] // 3
    if wqkv.shape != (heads, d, 3 * hd) or heads * hd > d:
        raise ValueError(f"wqkv must be (H, D, 3·hd) with H·hd ≤ D={d}, got "
                         f"{tuple(wqkv.shape)}")
    if bqkv.shape != (heads, 1, 3 * hd) or wo.shape != (heads, hd, d):
        raise ValueError(f"bqkv and wo must be ({heads}, 1, {3 * hd}) and ({heads}, {hd}, {d}), "
                         f"got {tuple(bqkv.shape)} and {tuple(wo.shape)}")
    weights = (wqkv, bqkv, wo) if bo is None else (wqkv, bqkv, wo, bo)
    if bo is not None and bo.shape != (1, d):
        raise ValueError(f"bo must be (1, {d}), got {tuple(bo.shape)}")
    if mask.shape != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({b}, {t}), got {mask.dtype} {tuple(mask.shape)}")
    if any(w.dtype != x.dtype for w in weights):
        raise TypeError(f"x and the weights must share a dtype, got {x.dtype} and "
                        f"{[w.dtype for w in weights]}")
    if any(a.device != x.device for a in (*weights, mask)):
        raise ValueError("x, the weights and mask must be on one device")


def _check_params(x, w_in, b_in, w_out, b_out, mask, heads) -> None:
    """The module's parameters at attention width A (= D, or a rank's
    subset of the heads): in_proj_weight (3A, D), in_proj_bias (3A,),
    out_proj.weight (D, A), out_proj.bias (D,) or None."""
    if x.dim() != 3 or w_in.dim() != 2:
        raise ValueError(f"x must be (B, T, D) and in_proj_weight (3A, D), got "
                         f"{tuple(x.shape)} and {tuple(w_in.shape)}")
    b, t, d = x.shape
    a = w_in.shape[0] // 3
    if a % heads or a > d or a == 0:
        raise ValueError(f"attention width A={a} (in_proj_weight {tuple(w_in.shape)}) is not "
                         f"{heads} heads of one size within D={d}")
    want = {"in_proj_weight": (w_in, (3 * a, d)), "in_proj_bias": (b_in, (3 * a,)),
            "out_proj.weight": (w_out, (d, a))}
    if b_out is not None:
        want["out_proj.bias"] = (b_out, (d,))
    for name, (w, shape) in want.items():
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} must be {shape} for D={d}, A={a}, got {tuple(w.shape)}")
    if mask.shape != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({b}, {t}), got {mask.dtype} {tuple(mask.shape)}")
    weights = [w for w, _ in want.values()]
    if any(w.dtype != x.dtype for w in weights):
        raise TypeError(f"x and the weights must share a dtype, got {x.dtype} and "
                        f"{[w.dtype for w in weights]}")
    if any(a.device != x.device for a in (*weights, mask)):
        raise ValueError("x, the weights and mask must be on one device")


def _check_kernel_inputs(x: torch.Tensor, heads: int, width: int) -> None:
    """What the kernels take: bf16 (wgmma products) or f32 (parity checks);
    head_dim 32 or 64 (the attention core), which also makes every row of
    the A-wide activations a multiple of the 16 bytes a TMA descriptor's
    stride must be, and D a multiple of 8 for x's; fewer elements than the
    TMA's 32-bit coordinates reach; a CUDA tensor. A shape it refuses
    raises: nothing falls back to gathering the heads."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    b, t, d = x.shape
    if width % heads or width // heads not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got A={width} over "
                         f"{heads} heads")
    if d % 8:
        raise ValueError(f"kernel takes D a multiple of 8, got D={d}")
    if b * t * max(3 * width, d) >= 2 ** 31:
        raise ValueError(f"kernel takes fewer than 2^31 elements of qkv and x, got "
                         f"{b}·{t}·max(3·{width}, {d})")
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block runs on cuda or cpu, not {x.device}")


def _aligned(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Contiguous and 16-byte aligned, copying only what is not (None
    stays None)."""
    out = [None if a is None else a.contiguous() for a in tensors]
    return [a if a is None or a.data_ptr() % 16 == 0 else a.clone() for a in out]


def unpack_weights(
    wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The inverse of ``pack_weights``: the JAX layouts ((H, D, 3·hd),
    (H, 1, 3·hd), (H, hd, D)) → the module's (3A, D) in_proj_weight, (3A,)
    bias and (D, A) out_proj.weight, A = H·hd, which the kernels take as
    they lie. Reshapes and permutes only (a gradient in the JAX layout maps
    the same way)."""
    heads, d, hd3 = wqkv.shape
    hd = hd3 // 3
    a = heads * hd
    w_in = wqkv.reshape(heads, d, 3, hd).permute(2, 0, 3, 1).reshape(3 * a, d)
    b_in = bqkv.reshape(heads, 3, hd).permute(1, 0, 2).reshape(3 * a)
    return w_in, b_in, wo.reshape(a, d).t()


def scratch_from_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernels' token-major layout of q, k, v (B, H, T, hd): one
    (B·T, 3D) matrix whose row b·T + t holds q | k | v, each (head, i) —
    the QKV product's natural output, and what the attention core reads
    with a row stride of 3D. dq, dk, dv share it; o and dO are (B·T, D)."""
    b, _, t, _ = q.shape
    return torch.cat([a.permute(0, 2, 1, 3).reshape(b * t, -1) for a in (q, k, v)], dim=1)


def heads_from_scratch(qkv: torch.Tensor, b: int, heads: int) -> list[torch.Tensor]:
    """q, k, v (B, H, T, hd) read back from ``scratch_from_heads``' layout,
    as the attention core addresses them: element (b, h, t, i) of part p at
    row b·T + t, column p·D + h·hd + i."""
    rows, d3 = qkv.shape
    hd = d3 // 3 // heads
    return [part.reshape(b, rows // b, heads, hd).permute(0, 2, 1, 3)
            for part in qkv.split(d3 // 3, dim=1)]


def _reference_params(x, w_in, b_in, w_out, b_out, mask, heads):
    """``fused_attention_block_reference`` on the module's parameters."""
    wqkv, bqkv, wo = pack_weights(w_in, b_in, w_out, heads)
    return fused_attention_block_reference(x, wqkv, bqkv, wo,
                                           None if b_out is None else b_out[None], mask)


def _bwd_reference_params(x, w_in, b_in, w_out, mask, g, heads):
    """``fused_attention_block_bwd_reference`` on the module's parameters,
    the weight gradients in their layouts: (dx, dw_in, db_in, dw_out, db_out)."""
    dx, dwqkv, dbqkv, dwo, dbo = fused_attention_block_bwd_reference(
        x, *pack_weights(w_in, b_in, w_out, heads), mask, g)
    return (dx, *unpack_weights(dwqkv, dbqkv, dwo), dbo.reshape(-1))


def weight_grad_tiles(d: int, a: Optional[int] = None) -> tuple[int, int]:
    """Output tiles of the weight-gradient products at model width D and
    attention width A (D by default): dW_in is (3A, D), dWo (D, A)."""
    a = d if a is None else a
    tiles = lambda n: -(-n // _TILE)
    return tiles(3 * a) * tiles(d), tiles(d) * tiles(a)


def weight_grad_splits(rows: int, tiles: int, sms: int) -> int:
    """Chunks of the rows a weight gradient sums over, each an f32 partial
    that is then summed in order: at most 16 chunks and at least 256 rows a
    chunk, so that the partials never scale with the batch. Within that, the
    count that leaves the card's ``sms`` persistent blocks the least work
    each — rounds of the tiles·chunks over the card, over the chunks — the
    smaller count on a tie."""
    best = 1
    for s in range(2, max(1, min(16, rows // 256)) + 1):
        if -(-tiles * s // sms) * best < -(-tiles * best // sms) * s:
            best = s
    return best


@launch_counted
def fused_attention_block_fwd(
    x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
    b_out: torch.Tensor, mask: torch.Tensor, heads: int,
) -> torch.Tensor:
    """(B, T, D) in x's dtype from the forward kernel, on the module's
    parameters at attention width A (in_proj_weight (3A, D), in_proj_bias
    (3A,), out_proj.weight (D, A), out_proj.bias (D,) or None for no bias).
    CUDA tensors only: the CPU path is ``fused_attention_block_reference``."""
    _check_params(x, w_in, b_in, w_out, b_out, mask, heads)
    a = w_in.shape[0] // 3
    _check_kernel_inputs(x, heads, a)
    b, t, d = x.shape
    x, w_in, b_in, w_out, b_out, mask = _aligned(x, w_in, b_in, w_out, b_out, mask)
    out = torch.empty_like(x)
    scratch = torch.empty(b * t * 4 * a, dtype=x.dtype, device=x.device)  # qkv, o
    with torch.cuda.device(x.device):
        err = _fwd_fn()(
            x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(),
            None if b_out is None else b_out.data_ptr(), mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, t, heads, a // heads, d, _DTYPE_CODES[x.dtype],
            1.0 / math.sqrt(a // heads), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention_block_fwd launch failed: cudaError_t {err}")
    fused_attention_block_fwd.launches += 1
    return out


@launch_counted
def fused_attention_block_bwd(
    x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
    mask: torch.Tensor, g: torch.Tensor, heads: int,
) -> tuple[torch.Tensor, ...]:
    """(dx, dw_in, db_in, dw_out, db_out) from the backward kernel at
    attention width A (the parameters as ``fused_attention_block_fwd``
    takes them): dx in x's dtype, the weight gradients in f32 and in the
    parameters' layouts, summed over the batch in a fixed order (two calls
    give equal bits); db_out is Σ g, the output bias's gradient where the
    block adds it. CUDA tensors only: the CPU path is
    ``fused_attention_block_bwd_reference``."""
    _check_params(x, w_in, b_in, w_out, None, mask, heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x: {g.dtype} {tuple(g.shape)} on {g.device}")
    a = w_in.shape[0] // 3
    _check_kernel_inputs(x, heads, a)
    b, t, d = x.shape
    hd = a // heads
    x, w_in, b_in, w_out, mask, g = _aligned(x, w_in, b_in, w_out, mask, g)
    dev = x.device
    rows = b * t
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles_in, tiles_out = weight_grad_tiles(d, a)
    splits_in = weight_grad_splits(rows, tiles_in, sms)
    splits_out = weight_grad_splits(rows, tiles_out, sms)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    grad_in = torch.empty(3 * a * d + 3 * a, **f32)  # dW_in (3A, D), then db_in
    grad_out = torch.empty(d * a + d, **f32)         # dW_out (D, A), then db_out
    # kernel scratch: qkv, o, dO, dqkv; row statistics; f32 partials
    acts = torch.empty(rows * 8 * a, dtype=x.dtype, device=dev)
    stats = torch.empty((b, heads, t, 2), **f32)
    dsum = torch.empty((b, heads, t), **f32)
    part_in = torch.empty((splits_in, grad_in.numel()), **f32)
    part_out = torch.empty((splits_out, grad_out.numel()), **f32)
    with torch.cuda.device(dev):
        err = _bwd_fn()(
            x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(), mask.data_ptr(),
            g.data_ptr(), dx.data_ptr(), grad_in.data_ptr(), grad_out.data_ptr(),
            acts.data_ptr(), stats.data_ptr(), dsum.data_ptr(), part_in.data_ptr(),
            part_out.data_ptr(), b, t, heads, hd, d, _DTYPE_CODES[x.dtype], splits_in,
            splits_out, 1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention_block_bwd launch failed: cudaError_t {err}")
    fused_attention_block_bwd.launches += 1
    return (dx, grad_in[: 3 * a * d].view(3 * a, d), grad_in[3 * a * d:],
            grad_out[: d * a].view(d, a), grad_out[d * a:])


class FusedAttentionBlock(torch.autograd.Function):
    """The block on the module's parameters with ``_bwd_kernel``'s gradient:
    the kernels on CUDA tensors, the plain versions on CPU tensors. Saves
    only its inputs, as the JAX ``_fwd`` does; the weight gradients come
    back in the parameters' layouts and dtype, as ``_bwd`` returns them.
    ``b_out`` may be None (a tensor-parallel rank's heads, whose output
    bias is added after the sum over the ranks)."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, w_out, b_out, mask, heads):
        if x.device.type == "cpu":
            out = _reference_params(x, w_in, b_in, w_out, b_out, mask, heads)
        else:
            out = fused_attention_block_fwd(x, w_in, b_in, w_out, b_out, mask, heads)
        ctx.save_for_backward(x, w_in, b_in, w_out, b_out, mask)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_in, b_in, w_out, b_out, mask = ctx.saved_tensors
        g = g.to(x.dtype)
        if x.device.type == "cpu":
            grads = _bwd_reference_params(x, w_in, b_in, w_out, mask, g, ctx.heads)
        else:
            grads = fused_attention_block_bwd(x, w_in, b_in, w_out, mask, g, ctx.heads)
        dx, dw_in, db_in, dw_out, db_out = grads
        return (dx, dw_in.to(w_in.dtype), db_in.to(b_in.dtype), dw_out.to(w_out.dtype),
                None if b_out is None else db_out.to(b_out.dtype), None, None)


def fused_self_attention(
    x: torch.Tensor, in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
    out_proj_weight: torch.Tensor, out_proj_bias: torch.Tensor, mask: torch.Tensor,
    heads: int,
) -> torch.Tensor:
    """The block on the torch module's parameters as they lie (no packing):
    (B, T, D) in x's dtype, differentiable in x and every parameter through
    ``FusedAttentionBlock``; without a gradient to keep, the forward runs
    alone. ``heads`` of width A = in_proj_weight.shape[0] / 3 (all of D's,
    or a tensor-parallel rank's subset); ``out_proj_bias`` None adds no
    bias."""
    _check_params(x, in_proj_weight, in_proj_bias, out_proj_weight, out_proj_bias, mask, heads)
    params = (in_proj_weight, in_proj_bias, out_proj_weight, out_proj_bias)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in (x, *params)):
        return FusedAttentionBlock.apply(x, *params, mask, heads)
    if x.device.type == "cpu":
        return _reference_params(x, *params, mask, heads)
    return fused_attention_block_fwd(x, *params, mask, heads)


def fused_attention_block(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
    bo: torch.Tensor, mask: torch.Tensor,
) -> torch.Tensor:
    """OutProj(MHSA(QKVProj(x))) with the JAX signature and layouts, (B, T, D)
    in x's dtype: the weights are unpacked to the module's layouts (views)
    and go through ``fused_self_attention``, so gradients reach them."""
    _check(x, wqkv, bqkv, wo, mask, bo)
    return fused_self_attention(x, *unpack_weights(wqkv, bqkv, wo), bo.reshape(-1), mask,
                                wqkv.shape[0])


@functools.cache
def _fwd_fn():
    fn = _build.load("fused_attention_block_fwd").wavjepa_fused_attention_block_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load("fused_attention_block_bwd").wavjepa_fused_attention_block_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 14 + [i] * 8 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn
