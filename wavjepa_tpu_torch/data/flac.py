"""FLAC payloads → ((C, T) float32 in [-1, 1], sample rate), on the native
decoder (``data/_native/flac_decoder.cc``) only.

Counterpart of ``wavjepa_tpu/data/flac.py`` without its ``soundfile``
fallback: when the decoder cannot be built or loaded, decoding raises with
the compiler's output rather than taking another path.
"""

from __future__ import annotations

import numpy as np


def decode(data: bytes) -> tuple[np.ndarray, int]:
    from wavjepa_tpu_torch.data._native.flac_native import decode_flac

    return decode_flac(data)
