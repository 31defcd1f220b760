"""LayerNorm in float32 with the residual add in front of it, forward and
backward: a hand-written Hopper kernel and its plain PyTorch versions.

Replaces no kernel of the JAX package: XLA fuses this norm there. The
kernels are ``csrc/layer_norm.cu``, whose source says what bounds them on
the card (memory) and how their design answers that.

``layer_norm32(x, weight, bias, eps, dtype, residual=None)`` is
``LayerNorm32``'s maths over the last dimension: s = x + residual rounded to
x's dtype (as the add rounds it), its mean and centred, biased variance in
float32, (s − mean)·rsqrt(var + eps)·weight + bias in float32 with the f32
parameters, rounded once to ``dtype``. When a gradient is wanted it goes
through ``LayerNorm32Function``, which keeps s (x itself without a residual)
and each row's f32 mean and rstd, and whose backward has one formula on both
devices: ds = rstd·(g − mean(g) − x̂·mean(g·x̂)) with g = dy·weight and
x̂ = (s − mean)·rstd, rounded once to s's dtype and returned for x and the
residual both; dweight = Σ dy·x̂ and dbias = Σ dy over the rows, in float32.
A CUDA tensor always goes to the kernels (bf16 or f32 in and out, the same
dtype for x and the residual, f32 parameters, a last dimension up to 1024;
anything else raises); a CPU tensor goes to the plain versions. Every call
counts ``layer_norm.kernel`` or ``layer_norm.plain`` in an open
``utils.profiling`` recording.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from wavjepa_tpu_torch.ops import _build
from wavjepa_tpu_torch.utils import profiling

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 1024  # the kernels hold a row in one warp's registers
_WARPS = 8  # rows a backward block walks at once (csrc/layer_norm.cu: kWarps)
_BLOCKS_PER_SM = 2  # backward blocks: the partial rows of dweight and dbias
_MIN_ROWS_PER_WARP = 4  # fewer, fuller blocks where the rows are few


def _reference_fwd(x, weight, bias, eps, dtype, residual=None):
    """The plain forward and what its backward keeps: (y, s, mean, rstd),
    mean and rstd of shape x.shape[:-1]. Computed in float32 (float64 for
    float64 inputs, for the tests)."""
    s = x if residual is None else x + residual
    x32 = s.to(torch.promote_types(s.dtype, torch.float32))
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd
    return (y * weight + bias).to(dtype), s, mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm32_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    dtype: torch.dtype, residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the forward: ``LayerNorm32``'s maths op for op."""
    return _reference_fwd(x, weight, bias, eps, dtype, residual)[0]


def layer_norm32_bwd_reference(
    dy: torch.Tensor, s: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
    weight: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel's maths: (ds in s's dtype,
    dweight and dbias in weight's), from the forward's s, mean and rstd."""
    d = s.shape[-1]
    acc = torch.promote_types(s.dtype, torch.float32)
    s2, dy2 = s.reshape(-1, d).to(acc), dy.reshape(-1, d).to(acc)
    xhat = (s2 - mean.reshape(-1, 1).to(acc)) * rstd.reshape(-1, 1).to(acc)
    g = dy2 * weight.to(acc)
    ds = rstd.reshape(-1, 1).to(acc) * (
        g - g.mean(dim=-1, keepdim=True) - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dw, db = (dy2 * xhat).sum(dim=0), dy2.sum(dim=0)
    return ds.to(s.dtype).reshape(s.shape), dw.to(weight.dtype), db.to(weight.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 32-byte aligned (the kernels' widest vector of
    f32 parameters or outputs), a copy if not."""
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_kernel_inputs(x, residual, dtype, **params) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm32 runs on cuda or cpu, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES or dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype} → {dtype}")
    if residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape
                                 or residual.device != x.device):
        raise ValueError(f"residual must match x ({x.dtype} {tuple(x.shape)}), got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"kernel takes a last dimension of 1 to {MAX_DIM}, got {d}")
    for name, p in params.items():
        if p.dtype != torch.float32 or p.shape != (d,) or p.device != x.device:
            raise ValueError(f"{name} must be f32 ({d},) on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")


@profiling.launch_counted
def layer_norm32_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    dtype: torch.dtype, residual: Optional[torch.Tensor] = None, save: bool = False,
) -> tuple[torch.Tensor, "torch.Tensor | None", "torch.Tensor | None", "torch.Tensor | None"]:
    """(y, s, mean, rstd) from the forward kernel; s, mean and rstd (what
    the backward needs; s is x itself without a residual) only when
    ``save``, else None. CUDA tensors only: the CPU path is
    ``layer_norm32_reference``."""
    _check_kernel_inputs(x, residual, dtype, weight=weight, bias=bias)
    d = x.shape[-1]
    x, weight, bias = _aligned(x), _aligned(weight), _aligned(bias)
    if residual is not None:
        residual = _aligned(residual)
    rows = x.numel() // d
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    s = mean = rstd = None
    if save:  # without a residual the kernel writes no s: it is x
        s = x if residual is None else torch.empty_like(x)
        mean, rstd = torch.empty((2, *x.shape[:-1]), dtype=torch.float32, device=x.device)
    with _on(x.device):
        err = _fwd_fn()(
            x.data_ptr(), _ptr(residual), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            _ptr(s), _ptr(mean), _ptr(rstd), rows, d, _DTYPE_CODES[x.dtype], _DTYPE_CODES[dtype],
            eps, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm32_fwd launch failed: cudaError_t {err}")
    layer_norm32_fwd.launches += 1
    return y, s, mean, rstd


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on(device: torch.device):
    """The device's context where it is not the current one already (the
    kernels launch on the current device)."""
    return _NOOP if device.index == torch.cuda.current_device() else torch.cuda.device(device)


_NOOP = contextlib.nullcontext()


def backward_parts(rows: int, device: torch.device) -> int:
    """The backward kernel's grid, which fixes how its rows are summed: one
    partial row of dweight and dbias a block."""
    per_block = _WARPS * _MIN_ROWS_PER_WARP
    return max(1, min(-(-rows // per_block), _BLOCKS_PER_SM * _sm_count(device.index)))


@profiling.launch_counted
def layer_norm32_bwd(
    dy: torch.Tensor, s: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
    weight: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ds, dweight, dbias) from the backward kernels (a pass over the rows,
    then the partial sums of the parameters' gradients in a fixed order: two
    calls give equal bits). CUDA tensors only: the CPU path is
    ``layer_norm32_bwd_reference``. Its ``launches`` counts calls (two
    kernels each)."""
    d = s.shape[-1]
    _check_kernel_inputs(s, None, dy.dtype, weight=weight)
    rows = s.numel() // d
    if dy.shape != s.shape or dy.device != s.device:
        raise ValueError(f"dy must be {tuple(s.shape)} on {s.device}, got {tuple(dy.shape)}")
    if any(t.dtype != torch.float32 or t.numel() != rows for t in (mean, rstd)):
        raise ValueError(f"mean and rstd must be f32 with {rows} rows")
    dy, s, weight = _aligned(dy), _aligned(s), _aligned(weight)
    mean, rstd = mean.contiguous(), rstd.contiguous()  # read a float at a time
    parts = backward_parts(rows, s.device)
    ds = torch.empty_like(s)
    dw = torch.empty(d, dtype=torch.float32, device=s.device)
    db = torch.empty_like(dw)  # not a view of dw's storage: each becomes a .grad
    scratch = torch.empty((2, parts, d), dtype=torch.float32, device=s.device)
    with _on(s.device):
        err = _bwd_fn()(
            dy.data_ptr(), s.data_ptr(), mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
            ds.data_ptr(), dw.data_ptr(), db.data_ptr(), scratch.data_ptr(), parts, rows, d,
            _DTYPE_CODES[s.dtype], _DTYPE_CODES[dy.dtype],
            torch.cuda.current_stream(s.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm32_bwd launch failed: cudaError_t {err}")
    layer_norm32_bwd.launches += 1
    return ds, dw, db


class LayerNorm32Function(torch.autograd.Function):
    """``layer_norm32`` with its closed-form gradient: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps, dtype):
        if x.device.type == "cpu":
            y, s, mean, rstd = _reference_fwd(x, weight, bias, eps, dtype, residual)
        else:
            y, s, mean, rstd = layer_norm32_fwd(x, weight, bias, eps, dtype, residual, save=True)
        ctx.save_for_backward(s, mean, rstd, weight)
        ctx.has_residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        s, mean, rstd, weight = ctx.saved_tensors
        if s.device.type == "cpu":
            ds, dw, db = layer_norm32_bwd_reference(dy, s, mean, rstd, weight)
        else:
            ds, dw, db = layer_norm32_bwd(dy, s, mean, rstd, weight)
        return ds, ds if ctx.has_residual else None, dw, db, None, None


def layer_norm32(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    dtype: torch.dtype, residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LayerNorm32 of ``x`` (+ ``residual``) over the last dimension, in
    ``dtype``. Differentiable in all four tensors through
    ``LayerNorm32Function``; without a gradient to keep, the forward runs
    alone and keeps nothing."""
    cpu = x.device.type == "cpu"
    profiling.count("layer_norm.plain" if cpu else "layer_norm.kernel", 1)
    tensors = (x, weight, bias) if residual is None else (x, residual, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return LayerNorm32Function.apply(x, residual, weight, bias, eps, dtype)
    if cpu:
        return layer_norm32_reference(x, weight, bias, eps, dtype, residual)
    return layer_norm32_fwd(x, weight, bias, eps, dtype, residual)[0]


def add_layer_norm32(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    eps: float, dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, s) of a pre-norm block's join: s = x + residual, rounded to x's
    dtype, is the residual stream, and y = LayerNorm32(s) in ``dtype``
    feeds the next sublayer; one kernel on the card, which writes s beside
    y. Forward only (serving): the card's route keeps no gradient."""
    cpu = x.device.type == "cpu"
    profiling.count("layer_norm.plain" if cpu else "layer_norm.kernel", 1)
    if cpu:
        y, s, _, _ = _reference_fwd(x, weight, bias, eps, dtype, residual)
        return y, s
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, residual, weight, bias)):
        raise NotImplementedError("add_layer_norm32 has no backward on the card (serving only)")
    y, s, _, _ = layer_norm32_fwd(x, weight, bias, eps, dtype, residual, save=True)
    return y, s


@functools.cache
def _fwd_fn():
    fn = _build.load("layer_norm").wavjepa_layer_norm_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load("layer_norm").wavjepa_layer_norm_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn
