"""Audio payloads of a shard sample → (waveform f32 (C, T), sample rate).

Counterpart of ``wavjepa_tpu/data/decode.py``:

  * ``.wav``: ``scipy.io.wavfile``; PCM8/16/32 scaled to [-1, 1] as
    torchaudio does, float kept as it is;
  * ``.npy``: a raw numpy array, with no rate (the noise and RIR shards);
  * ``.flac``: the native decoder (``data/flac.py``).
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

_PCM_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(data))
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[:, None]
    wav = wav.T  # (C, T)
    if wav.dtype == np.uint8:
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    elif wav.dtype in _PCM_SCALE:
        wav = wav.astype(np.float32) / _PCM_SCALE[wav.dtype]
    else:
        wav = wav.astype(np.float32)
    return np.ascontiguousarray(wav), int(sr)


def decode_npy(data: bytes) -> tuple[np.ndarray, Optional[int]]:
    arr = np.asarray(np.load(io.BytesIO(data), allow_pickle=False), np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    return arr, None


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    from wavjepa_tpu_torch.data import flac

    return flac.decode(data)


_DECODERS = {
    "wav": decode_wav,
    "npy": decode_npy,
    "flac": decode_flac,
}


def decode_audio(sample: dict[str, bytes]) -> tuple[np.ndarray, Optional[int]]:
    """The first decodable audio payload of a shard sample, by extension
    in the order wav, npy, flac."""
    for ext, decoder in _DECODERS.items():
        for key, payload in sample.items():
            if key == ext or key.endswith("." + ext):
                return decoder(payload)
    if any(k == "mp3" or k.endswith(".mp3") for k in sample):
        raise ValueError(
            "mp3 payloads are not supported by the first-party decoders "
            "(wav/npy/flac are); transcode mp3 datasets (e.g. FMA-small, "
            "MagnaTagATune) to wav/flac first"
        )
    raise ValueError(f"no decodable audio in sample keys={list(sample)}")
