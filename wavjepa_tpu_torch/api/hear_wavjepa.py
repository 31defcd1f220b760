"""HEAR model module: WavJEPA base (6-block conv frontend, 2.01-s windows).

Counterpart of ``wavjepa_tpu/api/hear_wavjepa.py``; runs on ``cuda`` unless
``device="cpu"`` is passed to ``load_model``.
"""

from wavjepa_tpu_torch.api import runtime as _runtime
from wavjepa_tpu_torch.api.runtime import (  # noqa: F401
    get_scene_embeddings,
    get_timestamp_embeddings,
)


def load_model(model_file_path: str = "", **kwargs):
    return _runtime.load_model(
        model_file_path,
        in_channels=1,
        model_size=kwargs.get("model_size", "base"),
        device=kwargs.get("device"),
    )
