"""Masked self-attention, forward and backward: hand-written Hopper kernels
and their plain PyTorch versions.

Counterpart of ``wavjepa_tpu/ops/flash_attention.py:flash_attention`` and
its custom VJP (``_fwd_kernel`` and ``_bwd_kernel``). The kernels are
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``; their
sources say what bounds them on the card and how their design answers that.

``flash_attention(q, k, v, mask)`` keeps the JAX layout: q, k, v are
(B, H, T, d), mask is (B, T) bool with True = ignore that key. When a
gradient is wanted it goes through ``FlashAttention``, a
``torch.autograd.Function`` whose backward has ``_bwd_kernel``'s maths on
both devices: P is recomputed, and a fully masked row (uniform P) keeps a
non-zero dS, as on the TPU, where autograd through ``masked_fill`` would
zero it. A CUDA tensor always goes to the kernels (bf16 or f32,
d ∈ {32, 64}; anything else raises); a CPU tensor goes to the plain
versions. The bf16 backward has two routes, chosen by the library
(``flash_attention_bwd_route``): one block per (batch, head) at T ≤ 128,
two passes of 64-row items above (dQ and each row's D, then dK and dV),
both on TMA and wgmma.

``relbias_attention(q, k, v, mask, table, gate)`` is the same forward with
WavLM's gated relative-position bias added to each scaled score,
g[b, h, q]·E[h, k − q] (``csrc/flash_attention_fwd.cuh``'s
``relbias_flash`` kernels; forward only). ``table`` is the per-offset bias
laid out as the kernel reads it (``relbias_offsets``), built once a
request; ``gate`` is (B, H, T) f32, one a layer.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from wavjepa_tpu_torch.ops import _build
from wavjepa_tpu_torch.utils.profiling import launch_counted

NEG_INF = torch.finfo(torch.float32).min  # masked keys: finite, as on the TPU

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def _softmax_probs(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                   bias: "torch.Tensor | None" = None) -> torch.Tensor:
    """f32 scores scaled by d^-½, plus ``bias`` (f32, broadcast to (B, H,
    T, T)) where given, masked keys at the f32 minimum (a fully masked row
    is uniform), f32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    return torch.softmax(s.masked_fill(mask[:, None, None, :], NEG_INF), dim=-1)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    bias: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Plain version of the forward kernel's maths: P rounded to the input
    dtype, f32-accumulated P·V, output in the input dtype. ``bias`` (f32,
    (B, H, T, T) or broadcast to it) is added to the scaled scores, as the
    ``relbias_flash`` kernels add the gated relative-position term."""
    p = _softmax_probs(q, k, mask, bias)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def relbias_offsets(t: int, device=None) -> torch.Tensor:
    """The offset k − q of each entry of a relative-position table row as
    the kernel reads it: (256·nb,) int64, nb = ⌈t/128⌉, entry i for offset
    i − (128·nb − 1). Every offset |k − q| < t is there; the margin's
    entries are read only for keys or rows past t, which the kernel drops,
    so any finite value does there."""
    nb = -(-t // 128)
    return torch.arange(256 * nb, device=device) - (128 * nb - 1)


def relbias_dense(table: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The gated bias materialised, (B, H, T, T) f32: gate[b, h, q] ·
    table[h, k − q + 128·nb − 1]. The plain version's, and the library
    route's, input; the kernel never forms it."""
    t = gate.shape[-1]
    pos = torch.arange(t, device=table.device)
    idx = pos[None, :] - pos[:, None] + (table.shape[-1] // 2 - 1)  # [q, k]
    return gate.float()[..., None] * table.float()[:, idx][None]


def _check_relbias(q, table, gate) -> None:
    b, h, t, _ = q.shape
    if table.shape != (h, 256 * -(-t // 128)) or table.dtype != torch.float32:
        raise ValueError(f"table must be f32 ({h}, {256 * -(-t // 128)}) (relbias_offsets), got "
                         f"{table.dtype} {tuple(table.shape)}")
    if gate.shape != (b, h, t) or gate.dtype != torch.float32:
        raise ValueError(f"gate must be f32 ({b}, {h}, {t}), got {gate.dtype} "
                         f"{tuple(gate.shape)}")
    if table.device != q.device or gate.device != q.device:
        raise ValueError("table and gate must be on q's device")


@launch_counted
def relbias_flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    table: torch.Tensor, gate: torch.Tensor,
) -> torch.Tensor:
    """The gated relative-position bias forward kernel's output. CUDA
    tensors only: the CPU path is ``flash_attention_reference`` with
    ``relbias_dense``."""
    _check(q, k, v, mask)
    _check_relbias(q, table, gate)
    table, gate = table.contiguous(), gate.contiguous()
    _check_kernel_inputs(mask, q, k, v, table)
    mask = _aligned_mask(mask)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _relbias_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), table.data_ptr(),
            gate.data_ptr(), out.data_ptr(), b, h, t, d, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"relbias_flash_attention_fwd launch failed: cudaError_t {err}")
    relbias_flash_attention_fwd.launches += 1
    return out


def relbias_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    table: torch.Tensor, gate: torch.Tensor,
) -> torch.Tensor:
    """Masked self-attention with the gated relative-position bias, forward
    only: the ``relbias_flash`` kernel on CUDA tensors, the plain formula
    on CPU tensors. Returns (B, H, T, d) in q's dtype."""
    _check(q, k, v, mask)
    _check_relbias(q, table, gate)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, relbias_dense(table, gate))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, table, gate)):
        raise NotImplementedError("relbias_attention has no backward kernel (serving only)")
    return relbias_flash_attention_fwd(q, k, v, mask, table, gate)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``_bwd_kernel``: recompute P; dV = P_loᵀ·dO;
    dP = dO·Vᵀ; dS = P⊙(dP − rowsum(dP⊙P)) in f32 with no zeroing at
    masked keys; dQ = d^-½·dS_lo·K and dK = d^-½·dS_loᵀ·Q, where ``_lo`` is
    rounded to the input dtype. Returns (dq, dk, dv) in the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _softmax_probs(q, k, mask)
    dof = do.float()
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_lo = ds.to(q.dtype).float()
    dq = scale * torch.matmul(ds_lo, k.float())
    dk = scale * torch.matmul(ds_lo.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(q, k, v, mask) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, d), got {tuple(q.shape)}")
    b, _, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if mask.shape != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({b}, {t}), got {mask.dtype} {tuple(mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if any(x.device != q.device for x in (k, v, mask)):
        raise ValueError("q, k, v and mask must be on one device")


def _check_kernel_inputs(mask: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the kernels take: CUDA, bf16 or f32, head_dim 32 or 64, a
    contiguous mask and contiguous, 16-byte aligned tensors (read 16 bytes
    at a time, or by TMA)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {q.shape[-1]}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in tensors):
        raise ValueError("q, k, v (and dO, stats) must be contiguous and 16-byte aligned")


def _aligned_mask(mask: torch.Tensor) -> torch.Tensor:
    """The mask where TMA can load it: 16-byte aligned (a copy if not)."""
    return mask if mask.data_ptr() % 16 == 0 else mask.clone()


@launch_counted
def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    with_stats: bool = False,
) -> tuple[torch.Tensor, "torch.Tensor | None"]:
    """(out, stats) from the forward kernel: stats is each query row's f32
    (max, sum) pair, (B, H, T, 2), for the backward when ``with_stats``,
    else None. CUDA tensors only: the CPU path is
    ``flash_attention_reference``."""
    _check(q, k, v, mask)
    _check_kernel_inputs(mask, q, k, v)
    mask = _aligned_mask(mask)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((b, h, t, 2), dtype=torch.float32, device=q.device)
             if with_stats else None)
    with torch.cuda.device(q.device):
        err = _fwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            b, h, t, d, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    flash_attention_fwd.launches += 1
    return out, stats


@launch_counted
def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    do: torch.Tensor, stats: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernel, given the forward's row
    statistics. CUDA tensors only: the CPU path is
    ``flash_attention_bwd_reference``."""
    _check(q, k, v, mask)
    do = do.contiguous()
    if do.data_ptr() % 16:
        do = do.clone()
    b, h, t, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: {do.dtype} {tuple(do.shape)} on {do.device}")
    if stats.shape != (b, h, t, 2) or stats.dtype != torch.float32:
        raise ValueError(f"stats must be f32 ({b}, {h}, {t}, 2), got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    _check_kernel_inputs(mask, q, k, v, do, stats)
    mask = _aligned_mask(mask)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # scratch of the two-pass route (T > 128 in bf16, and f32): each row's D
    dsum = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(),
            stats.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, t, d, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError_t {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


BWD_ROUTES = {0: "fma", 1: "single_pass", 2: "two_pass"}


def flash_attention_bwd_route(t: int, head_dim: int, dtype: torch.dtype) -> str:
    """Which kernel ``flash_attention_bwd`` (and the fused block's backward)
    runs at sequence length t: "fma" (f32), "single_pass" (bf16, T ≤ 128,
    one block per (batch, head)) or "two_pass" (bf16 above: 64-row items,
    dQ and D, then dK and dV). The library decides; this asks it, so it
    needs the card's build."""
    code = _route_fn()(t, head_dim, _DTYPE_CODES.get(dtype, -1))
    if code not in BWD_ROUTES:
        raise ValueError(f"no backward kernel for T={t}, head_dim={head_dim}, {dtype}")
    return BWD_ROUTES[code]


class FlashAttention(torch.autograd.Function):
    """Attention with ``_bwd_kernel``'s gradient: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        if q.device.type == "cpu":
            out, stats = flash_attention_reference(q, k, v, mask), None
        else:
            out, stats = flash_attention_fwd(q, k, v, mask, with_stats=True)
        ctx.save_for_backward(q, k, v, mask, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, stats = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, mask, do)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, mask, do, stats)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Fused masked self-attention; returns (B, H, T, d) in q's dtype.
    Differentiable in q, k and v through ``FlashAttention``; without a
    gradient to keep, the forward runs alone and keeps no statistics."""
    _check(q, k, v, mask)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask)
    return flash_attention_fwd(q, k, v, mask)[0]


@functools.cache
def _fwd_fn():
    fn = _build.load("flash_attention_fwd").wavjepa_flash_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _relbias_fn():
    fn = _build.load("flash_attention_fwd").wavjepa_relbias_flash_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _route_fn():
    fn = _build.load("flash_attention_bwd").wavjepa_flash_attention_bwd_route
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load("flash_attention_bwd").wavjepa_flash_attention_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn
