"""HuggingFace-style inference entry point, as the published
``labhamlet/wavjepa-base`` model is used:

    extractor = WavJEPAFeatureExtractor()
    model = WavJEPAForAudioEmbeddings.from_pretrained(ckpt)
    inputs = extractor(audio_16k)                    # (1, 1, 160000)
    embeddings, timestamps = model(inputs)           # (1, S, 768), (1, S) ms

Counterpart of ``wavjepa_tpu/api/hf.py``. For ``wavjepa-nat-base`` pass
``in_channels=2, channel_wise=True`` and feed (1, 2, 160000) binaural input.
The model runs on ``cuda`` unless ``from_pretrained`` is given
``device="cpu"``, and returns torch tensors on its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wavjepa_tpu_torch.api.feature_helper import prepare_batch
from wavjepa_tpu_torch.api.runtime import DeviceLike, RuntimeJEPA, load_model


class WavJEPAFeatureExtractor:
    """AutoFeatureExtractor analog: resampling to ``sampling_rate`` when the
    input's rate differs, channel adaptation, −14 dBFS RMS normalisation and
    batching → (B, in_channels, T) float32."""

    def __init__(self, sampling_rate: int = 16000, in_channels: int = 1):
        self.sampling_rate = sampling_rate
        self.in_channels = in_channels

    def __call__(self, audio, sampling_rate: Optional[int] = None) -> np.ndarray:
        arr = np.asarray(audio, np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        if sampling_rate is not None and sampling_rate != self.sampling_rate:
            from wavjepa_tpu_torch.data.resample import resample_np

            arr = resample_np(arr, sampling_rate, self.sampling_rate)
        if arr.ndim not in (2, 3):  # (B, T) or (B, C, T)
            raise ValueError(f"unsupported audio input shape {arr.shape}")
        return prepare_batch(list(arr), self.in_channels)


class WavJEPAForAudioEmbeddings:
    """AutoModel analog over the HEAR runtime: input_values → (embeddings,
    timestamps)."""

    def __init__(self, runtime: RuntimeJEPA):
        self.runtime = runtime
        self.config = runtime.config

    @classmethod
    def from_pretrained(
        cls,
        checkpoint_path: str = "",
        in_channels: int = 1,
        channel_wise: bool = False,
        model_size: str = "base",
        device: DeviceLike = None,
    ) -> "WavJEPAForAudioEmbeddings":
        return cls(
            load_model(
                checkpoint_path,
                in_channels=in_channels,
                channel_wise=channel_wise,
                model_size=model_size,
                device=device,
            )
        )

    def __call__(self, input_values) -> tuple[torch.Tensor, torch.Tensor]:
        return self.runtime.get_timestamp_embeddings(input_values)
