"""Projection-fused attention block, forward and backward: hand-written
Hopper kernels and their plain PyTorch versions.

Counterpart of ``wavjepa_tpu/ops/fused_attention_block.py``:
``fused_attention_block`` and its custom VJP (``_fwd_kernel`` and
``_bwd_kernel``), which compute OutProj(MHSA(QKVProj(x))) per batch row.
The kernels are ``csrc/fused_attention_block_fwd.cu`` and
``csrc/fused_attention_block_bwd.cu``; their sources say what bounds them on
the card and how their design answers that.

``fused_attention_block(x, wqkv, bqkv, wo, bo, mask)`` keeps the JAX
signature (``interpret`` dropped) and layouts: x (B, T, D); wqkv (H, D, 3·hd)
with column blocks [Wq_h | Wk_h | Wv_h]; bqkv (H, 1, 3·hd); wo (H, hd, D);
bo (1, D); mask (B, T) bool, True = ignore that key. ``pack_weights`` makes
those layouts from the port's torch parameters. When a gradient is wanted it
goes through ``FusedAttentionBlock``, a ``torch.autograd.Function`` that
saves only its inputs and whose backward has ``_bwd_kernel``'s maths on both
devices: a fully masked row (uniform P) keeps a non-zero dS, where autograd
through ``masked_fill`` would zero it. A CUDA tensor always goes to the
kernels (bf16 or f32, head_dim 32 or 64; anything else raises); a CPU tensor
goes to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from wavjepa_tpu_torch.ops import _build

# −0.7·f32max, as the JAX kernel: finite, so a fully masked row is uniform
NEG_BIG = -0.7 * torch.finfo(torch.float32).max

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_TILE = 64  # rows and columns of a weight gradient a kernel block owns


def pack_weights(
    in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
    out_proj_weight: torch.Tensor, heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The port's (3D, D) packed-QKV weight (rows q | k | v, each head-major),
    (3D,) bias and (D, D) ``out_proj.weight`` → the kernels' per-head layouts
    ((H, D, 3·hd), (H, 1, 3·hd), (H, hd, D)). Reshapes and permutes only, so
    autograd carries the gradients back to the parameters."""
    d = in_proj_weight.shape[1]
    hd = d // heads
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
    rounded, acc = Σ_h o_h·Wo[h] + bo in f32, rounded once."""
    hd = wqkv.shape[-1] // 3
    q, k, v = _qkv_heads(x, wqkv, bqkv).split(hd, dim=-1)
    p = _probs(q, k, mask).to(x.dtype)
    o = torch.matmul(p.float(), v.float()).to(x.dtype)
    acc = torch.einsum("bhti,hin->btn", o.float(), wo.float())
    return (acc + bo.float()).to(x.dtype)


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
    if wqkv.shape != (heads, d, 3 * hd) or heads * hd != d:
        raise ValueError(f"wqkv must be (H, D, 3·D/H) for D={d}, got {tuple(wqkv.shape)}")
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


def _check_kernel_inputs(x: torch.Tensor, heads: int) -> None:
    """What the kernels take: CUDA, bf16 or f32, head_dim 32 or 64."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.shape[-1] // heads not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {x.shape[-1] // heads}")


def _kernel_operands(x, wqkv, bqkv, wo, mask):
    """Contiguous, 16-byte aligned operands in the kernels' layouts (a few
    copies of D² weights): Wqkv as (3D, D) rows (part, head, i), which is
    torch's in_proj layout, its bias (3D,) in the same order, Wo as (D, D)
    rows (head, i)."""
    heads, d, hd3 = wqkv.shape
    hd = hd3 // 3
    w_in = wqkv.reshape(heads, d, 3, hd).permute(2, 0, 3, 1).reshape(3 * d, d).contiguous()
    b_in = bqkv.reshape(heads, 3, hd).permute(1, 0, 2).reshape(3 * d).contiguous()
    w_out = wo.reshape(d, d).contiguous()
    x, mask = x.contiguous(), mask.contiguous()
    out = [x, w_in, b_in, w_out, mask]
    return [a if a.data_ptr() % 16 == 0 else a.clone() for a in out]


def weight_grad_splits(rows: int, tiles: int, sms: int) -> int:
    """Chunks of the rows a weight gradient sums over, each summed by its own
    blocks into an f32 partial and the partials then summed in order: enough
    blocks for about four waves of the card's ``sms`` multiprocessors, at
    least 256 rows a chunk and at most 16 chunks, so that the partials never
    scale with the batch."""
    return max(1, min(16, -(-4 * sms // tiles), rows // 256))


def fused_attention_block_fwd(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
    bo: torch.Tensor, mask: torch.Tensor,
) -> torch.Tensor:
    """(B, T, D) in x's dtype from the forward kernel. CUDA tensors only:
    the CPU path is ``fused_attention_block_reference``."""
    _check(x, wqkv, bqkv, wo, mask, bo)
    heads = wqkv.shape[0]
    _check_kernel_inputs(x, heads)
    b, t, d = x.shape
    x, w_in, b_in, w_out, mask = _kernel_operands(x, wqkv, bqkv, wo, mask)
    bo = bo.reshape(d).contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty((4, b * t * d), dtype=x.dtype, device=x.device)  # q, k, v, o
    with torch.cuda.device(x.device):
        err = _fwd_fn()(
            x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(), bo.data_ptr(),
            mask.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, t, heads, d // heads, _DTYPE_CODES[x.dtype], 1.0 / math.sqrt(d // heads),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention_block_fwd launch failed: cudaError_t {err}")
    fused_attention_block_fwd.launches += 1
    return out


fused_attention_block_fwd.launches = 0  # kernel launches; the CPU path never counts


def fused_attention_block_bwd(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
    mask: torch.Tensor, g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """(dx, dwqkv, dbqkv, dwo, dbo) from the backward kernel: dx in x's dtype,
    the weight gradients in f32, summed over the batch in a fixed order (two
    calls give equal bits). CUDA tensors only: the CPU path is
    ``fused_attention_block_bwd_reference``."""
    b, t, d = x.shape
    _check(x, wqkv, bqkv, wo, mask)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x: {g.dtype} {tuple(g.shape)} on {g.device}")
    heads = wqkv.shape[0]
    _check_kernel_inputs(x, heads)
    hd = d // heads
    x, w_in, b_in, w_out, mask = _kernel_operands(x, wqkv, bqkv, wo, mask)
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    dev = x.device
    rows, tiles = b * t, -(-d // _TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits_in = weight_grad_splits(rows, 3 * tiles * tiles, sms)
    splits_out = weight_grad_splits(rows, tiles * tiles, sms)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    grad_in = torch.empty(3 * d * d + 3 * d, **f32)  # dW (D, 3D) columns (part, head, i), then db
    grad_out = torch.empty(d * d + d, **f32)         # dWo (D, D) rows (head, i), then dbo
    # kernel scratch: q, k, v, o, dO, dq, dk, dv; row statistics; f32 partials
    acts = torch.empty((8, rows * d), dtype=x.dtype, device=dev)
    stats = torch.empty((b, heads, t, 2), **f32)
    dsum = torch.empty((b, heads, t), **f32)
    part_in = torch.empty((splits_in, grad_in.numel()), **f32)
    part_out = torch.empty((splits_out, grad_out.numel()), **f32)
    with torch.cuda.device(dev):
        err = _bwd_fn()(
            x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(), mask.data_ptr(),
            g.data_ptr(), dx.data_ptr(), grad_in.data_ptr(), grad_out.data_ptr(),
            acts.data_ptr(), stats.data_ptr(), dsum.data_ptr(), part_in.data_ptr(),
            part_out.data_ptr(), b, t, heads, hd, _DTYPE_CODES[x.dtype], splits_in, splits_out,
            1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention_block_bwd launch failed: cudaError_t {err}")
    fused_attention_block_bwd.launches += 1
    dw_in, db_in = grad_in[: 3 * d * d].view(d, 3, heads, hd), grad_in[3 * d * d:]
    dwqkv = dw_in.permute(2, 0, 1, 3).reshape(heads, d, 3 * hd)
    dbqkv = db_in.view(3, heads, hd).permute(1, 0, 2).reshape(heads, 1, 3 * hd)
    dwo = grad_out[: d * d].view(heads, hd, d)
    dbo = grad_out[d * d:].view(1, d)
    return dx, dwqkv, dbqkv, dwo, dbo


fused_attention_block_bwd.launches = 0  # kernel launches; the CPU path never counts


class FusedAttentionBlock(torch.autograd.Function):
    """The block with ``_bwd_kernel``'s gradient: the kernels on CUDA
    tensors, the plain versions on CPU tensors. Saves only its inputs, as
    the JAX ``_fwd`` does; the weight gradients come back in the weights'
    dtype, as ``_bwd`` returns them."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, mask):
        if x.device.type == "cpu":
            out = fused_attention_block_reference(x, wqkv, bqkv, wo, bo, mask)
        else:
            out = fused_attention_block_fwd(x, wqkv, bqkv, wo, bo, mask)
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wo, bo, mask = ctx.saved_tensors
        g = g.to(x.dtype)
        if x.device.type == "cpu":
            grads = fused_attention_block_bwd_reference(x, wqkv, bqkv, wo, mask, g)
        else:
            grads = fused_attention_block_bwd(x, wqkv, bqkv, wo, mask, g)
        dx, dwqkv, dbqkv, dwo, dbo = grads
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype),
                dbo.to(bo.dtype), None)


def fused_attention_block(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
    bo: torch.Tensor, mask: torch.Tensor,
) -> torch.Tensor:
    """OutProj(MHSA(QKVProj(x))), (B, T, D) in x's dtype. Differentiable in
    x and every weight through ``FusedAttentionBlock``; without a gradient
    to keep, the forward runs alone."""
    _check(x, wqkv, bqkv, wo, mask, bo)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, wqkv, bqkv, wo, bo)):
        return FusedAttentionBlock.apply(x, wqkv, bqkv, wo, bo, mask)
    if x.device.type == "cpu":
        return fused_attention_block_reference(x, wqkv, bqkv, wo, bo, mask)
    return fused_attention_block_fwd(x, wqkv, bqkv, wo, bo, mask)


@functools.cache
def _fwd_fn():
    fn = _build.load("fused_attention_block_fwd").wavjepa_fused_attention_block_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load("fused_attention_block_bwd").wavjepa_fused_attention_block_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 14 + [i] * 7 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn
