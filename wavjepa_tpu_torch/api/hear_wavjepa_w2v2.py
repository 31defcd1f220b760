"""HEAR model module: WavJEPA with the wav2vec2 frontend (7 conv layers,
stride 320, 20-ms frames; 4.02-s windows of 200 tokens).

Counterpart of ``wavjepa_tpu/api/hear_wavjepa_w2v2.py``; runs on ``cuda``
unless ``device="cpu"`` is passed to ``load_model``. A window is
``int(16000 · 4.02)`` = 64319 samples, as in the JAX package.
"""

import torch

from wavjepa_tpu_torch.api import runtime as _runtime
from wavjepa_tpu_torch.api.runtime import (  # noqa: F401
    get_scene_embeddings,
    get_timestamp_embeddings,
)
from wavjepa_tpu_torch.models.jepa import JEPAConfig
from wavjepa_tpu_torch.ops.conv_frontend import WAV2VEC2_CONV_SPEC


def w2v2_config(model_size: str = "base") -> JEPAConfig:
    return JEPAConfig(
        conv_spec=WAV2VEC2_CONV_SPEC,
        in_channels=1,
        process_seconds=4.02,
        size=model_size,
        dtype=torch.bfloat16,
    )


def load_model(model_file_path: str = "", **kwargs):
    return _runtime.load_model(
        model_file_path,
        config=w2v2_config(kwargs.get("model_size", "base")),
        device=kwargs.get("device"),
        seed=kwargs.get("seed", 0),
    )
