"""ARCH embedding-model contract and the WavJEPA implementation.

The port's copy of ``wavjepa_tpu/eval/arch/model.py``: −14 dBFS RMS
normalisation over the whole clip, zero-padding to a multiple of the 2.01-s
window, the encoder's tokens a window with the padded ones dropped, the
mean over the tokens for a clip embedding and the tokens themselves for
token embeddings. The runtime computes on its device (``cuda`` unless the
caller asks for the CPU) and hands back device tensors; the embeddings
are reduced there and returned as float32 numpy arrays.
"""

from __future__ import annotations

import numpy as np

from wavjepa_tpu_torch.api.runtime import DeviceLike, RuntimeJEPA


class Model:
    """Embedding-model contract for ARCH evaluators."""

    def __init__(self, model=None, **kwargs):
        self.model = model
        for key, value in kwargs.items():
            setattr(self, key, value)

    def get_embeddings(self, audio: np.ndarray, **kwargs) -> np.ndarray:
        """Whole-clip embedding → (embedding_size,)."""
        raise NotImplementedError

    def get_token_embeddings(self, audio: np.ndarray, **kwargs) -> np.ndarray:
        """Per-frame embeddings → (n_frames, embedding_size)."""
        raise NotImplementedError

    def get_classification_embedding_size(self) -> int:
        raise NotImplementedError

    def get_token_embedding_size(self) -> int:
        raise NotImplementedError

    def get_sampling_rate(self) -> int:
        raise NotImplementedError


class WavJEPAModel(Model):
    """ARCH Model over the port's HEAR runtime (``api/runtime.py``)."""

    def __init__(self, runtime: RuntimeJEPA):
        super().__init__(model=runtime)
        self.runtime = runtime

    @classmethod
    def from_checkpoint(cls, ckpt_path: str = "", model_size: str = "base",
                        device: DeviceLike = None, **kwargs) -> "WavJEPAModel":
        from wavjepa_tpu_torch.api.runtime import load_model

        return cls(load_model(ckpt_path, model_size=model_size, device=device, **kwargs))

    def _normalize(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        rms = np.sqrt(np.mean(np.square(audio)))
        if rms > 0:
            audio = audio * 10.0 ** ((-14.0 - 20.0 * np.log10(rms)) / 20.0)
        return audio

    def get_token_embeddings(self, audio: np.ndarray, **kwargs) -> np.ndarray:
        emb, _ = self.runtime.get_timestamp_embeddings(self._normalize(audio))
        return emb[0].cpu().numpy()

    def get_embeddings(self, audio: np.ndarray, **kwargs) -> np.ndarray:
        emb, _ = self.runtime.get_timestamp_embeddings(self._normalize(audio))
        return emb[0].mean(dim=0).cpu().numpy()

    def get_batch_embeddings(self, audios, mode: str = "linear"):
        """The batched path of the ``ClassificationDataset`` precompute: one
        runtime call a batch of equal-length clips; the token mean of each
        clip taken on the device, or its tokens for attention pooling."""
        batch = np.stack([self._normalize(a)[0] for a in audios])
        emb, _ = self.runtime.get_timestamp_embeddings(batch)
        if mode == "attention-pooling":
            return list(emb.cpu().numpy())
        return list(emb.mean(dim=1).cpu().numpy())

    def get_classification_embedding_size(self) -> int:
        return self.runtime.scene_embedding_size

    def get_token_embedding_size(self) -> int:
        return self.runtime.timestamp_embedding_size

    def get_sampling_rate(self) -> int:
        return self.runtime.sample_rate


class HFWrapperModel(WavJEPAModel):
    """ARCH Model over the HF-style surface: the same embeddings, loaded
    through ``WavJEPAForAudioEmbeddings.from_pretrained``."""

    @classmethod
    def from_pretrained(cls, checkpoint_path: str = "", device: DeviceLike = None,
                        **kwargs) -> "HFWrapperModel":
        from wavjepa_tpu_torch.api.hf import WavJEPAForAudioEmbeddings

        hf = WavJEPAForAudioEmbeddings.from_pretrained(checkpoint_path, device=device, **kwargs)
        return cls(hf.runtime)
