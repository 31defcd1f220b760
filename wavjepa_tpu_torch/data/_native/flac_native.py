"""ctypes binding of the native FLAC decoder (flac_decoder.cc)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from wavjepa_tpu_torch.data._native.build import load

_ERRORS = {
    -1: "bad magic / missing STREAMINFO",
    -2: "unsupported stream parameters",
    -3: "corrupt frame",
    -4: "allocation failure",
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load()
    lib.wavjepa_flac_decode.restype = ctypes.c_int
    lib.wavjepa_flac_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wavjepa_flac_free.restype = None
    lib.wavjepa_flac_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    return lib


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """FLAC bytes → ((C, T) float32 in [-1, 1], sample_rate)."""
    lib = _lib()
    samples = ctypes.POINTER(ctypes.c_float)()
    channels = ctypes.c_int32()
    frames = ctypes.c_int64()
    rate = ctypes.c_int32()
    code = lib.wavjepa_flac_decode(
        data, len(data),
        ctypes.byref(samples), ctypes.byref(channels),
        ctypes.byref(frames), ctypes.byref(rate),
    )
    if code != 0:
        raise ValueError(f"FLAC decode failed: {_ERRORS.get(code, code)}")
    try:
        n = channels.value * frames.value
        arr = np.ctypeslib.as_array(samples, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    finally:
        lib.wavjepa_flac_free(samples)
    return arr.reshape(channels.value, frames.value), rate.value
