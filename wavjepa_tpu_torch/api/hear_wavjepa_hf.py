"""HEAR model module over the HF-style surface: the scene embedding is the
time-mean of the model's output.

Counterpart of ``wavjepa_tpu/api/hear_wavjepa_hf.py``; runs on ``cuda``
unless ``device="cpu"`` is passed to ``load_model``.
"""

from wavjepa_tpu_torch.api.hf import WavJEPAForAudioEmbeddings


def load_model(model_file_path: str = "", **kwargs):
    model = WavJEPAForAudioEmbeddings.from_pretrained(
        model_file_path,
        in_channels=kwargs.get("in_channels", 1),
        channel_wise=kwargs.get("channel_wise", False),
        model_size=kwargs.get("model_size", "base"),
        device=kwargs.get("device"),
    )
    model.sample_rate = model.runtime.sample_rate
    model.scene_embedding_size = model.runtime.scene_embedding_size
    model.timestamp_embedding_size = model.runtime.timestamp_embedding_size
    return model


def get_timestamp_embeddings(audio, model):
    return model(audio)


def get_scene_embeddings(audio, model):
    emb, _ = model(audio)
    return emb.mean(dim=1)
