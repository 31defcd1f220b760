"""HEAR model module: WavLM Large (``models/wavlm.py``), whole utterances.

Runs on ``cuda`` unless ``device="cpu"`` is passed to ``load_model``. The
model file is a ``transformers``-named state dict
(``api/convert.state_dict_from_hf_wavlm``); without one the weights are
drawn from ``seed``. Timestamp embeddings are WavLM's 20-ms frames.
"""

from wavjepa_tpu_torch.api import runtime as _runtime
from wavjepa_tpu_torch.api.runtime import (  # noqa: F401
    get_scene_embeddings,
    get_timestamp_embeddings,
)


def load_model(model_file_path: str = "", **kwargs):
    return _runtime.load_wavlm(model_file_path, config=kwargs.get("config"),
                               device=kwargs.get("device"), seed=kwargs.get("seed", 0))
