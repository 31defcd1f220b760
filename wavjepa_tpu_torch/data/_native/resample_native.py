"""ctypes binding of the native polyphase resampler (resampler.cc)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from wavjepa_tpu_torch.data._native.build import load


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load()
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.wavjepa_resample_poly.restype = ctypes.c_int
    lib.wavjepa_resample_poly.argtypes = [
        f32, ctypes.c_int64, ctypes.c_int64,
        f32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32, ctypes.c_int64,
    ]
    return lib


def resample_poly_native(x: np.ndarray, kernel: np.ndarray, L: int, M: int,
                         t_out: int) -> np.ndarray:
    """(rows, T) f32 × centred FIR kernel → (rows, t_out) f32, the
    semantics of ``scipy.signal.resample_poly`` with ``window=kernel / L``."""
    x = np.ascontiguousarray(x, np.float32)
    kernel = np.ascontiguousarray(kernel, np.float32)
    if x.ndim != 2 or kernel.ndim != 1:
        raise ValueError(f"expected (rows, T) input and a 1-D kernel, got {x.shape}, {kernel.shape}")
    rows, t_in = x.shape
    out = np.empty((rows, t_out), np.float32)
    code = _lib().wavjepa_resample_poly(x, rows, t_in, kernel, kernel.size, L, M, out, t_out)
    if code != 0:
        raise ValueError(f"native resample failed (code {code})")
    return out
