"""Masked self-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``wavjepa_tpu/ops/flash_attention.py:flash_attention`` (the
forward, ``_fwd_kernel``). The kernel is ``csrc/flash_attention_fwd.cu``; its
source says what bounds it on the card and how its design answers that.

``flash_attention(q, k, v, mask)`` keeps the JAX layout: q, k, v are
(B, H, T, d), mask is (B, T) bool with True = ignore that key. A CUDA tensor
always goes to the kernel (bf16 or f32, d ∈ {32, 64}; anything else raises);
a CPU tensor goes to ``flash_attention_reference``, the same maths in plain
PyTorch. No gradient yet: inference runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from wavjepa_tpu_torch.ops import _build

NEG_INF = torch.finfo(torch.float32).min  # masked keys: finite, as on the TPU

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel's maths: f32 scores scaled by d^-½,
    masked keys set to the f32 minimum (a fully masked row is uniform), f32
    softmax, P rounded to the input dtype, f32-accumulated P·V, output in
    the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(q.dtype).float(), v.float())
    return o.to(q.dtype)


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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Fused masked self-attention; returns (B, H, T, d) in q's dtype."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    b, h, t, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if not all(x.is_contiguous() for x in (q, k, v, mask)):
        raise ValueError("q, k, v and mask must be contiguous")
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, t, d, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches; the CPU path never counts


@functools.cache
def _kernel():
    lib = _build.load("flash_attention_fwd")
    fn = lib.wavjepa_flash_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn
