"""HEAR model module: WavJEPA-Nat (2 channels by default, a conv frontend a
channel, timestamp embeddings averaged over the channels).

Counterpart of ``wavjepa_tpu/api/hear_natjepa.py``; runs on ``cuda`` unless
``device="cpu"`` is passed to ``load_model``. The position table comes from
the checkpoint's sidecar or is detected from its stored table unless
``pos_embed`` is given; the window is the sidecar's, else 2.01 s.
"""

from wavjepa_tpu_torch.api import runtime as _runtime
from wavjepa_tpu_torch.api.runtime import (  # noqa: F401
    get_scene_embeddings,
    get_timestamp_embeddings,
)


def load_model(model_file_path: str = "", in_channels: int = 2, **kwargs):
    return _runtime.load_model(
        model_file_path,
        in_channels=in_channels,
        model_size=kwargs.get("model_size", "base"),
        channel_wise=True,
        pos_embed=kwargs.get("pos_embed"),
        device=kwargs.get("device"),
        seed=kwargs.get("seed", 0),
    )
