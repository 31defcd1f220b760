"""ARCH datasets: views over (audio paths or audios, labels) that
precompute their embeddings.

The port's copy of ``wavjepa_tpu/eval/arch/datasets.py``. Embeddings are
computed a batch at a time: the clips of a batch are zero-padded to its
longest, so the padding enters a clip's token mean as it does in the JAX
package; in-memory audios are taken longest first, files in their order.
A cache shared across a recipe's folds and modes, keyed by (path,
``"clip"`` or ``"token"``), embeds each file once a kind. Token embeddings
are zero-padded to the longest clip for attention pooling.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


def load_clip(path: str, target_sr: int) -> np.ndarray:
    """Decode an audio file to mono f32 at target_sr."""
    from wavjepa_tpu_torch.data.decode import decode_audio
    from wavjepa_tpu_torch.data.resample import resample_np

    with open(path, "rb") as f:
        data = f.read()
    ext = path.rsplit(".", 1)[-1].lower()
    wav, sr = decode_audio({ext: data})
    if wav.ndim > 1:
        wav = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
    if sr is not None and sr != target_sr:
        wav = resample_np(wav[None], sr, target_sr)[0]
    return wav.astype(np.float32)


class ClassificationDataset:
    """Holds (audio_paths | audios, labels); precomputes embeddings through
    the ARCH Model."""

    def __init__(
        self,
        audio_paths: Optional[Sequence[str]] = None,
        audios: Optional[Sequence[np.ndarray]] = None,
        labels: Union[List[int], np.ndarray, None] = None,
        model=None,
        sampling_rate: int = 16000,
        precompute_embeddings: bool = True,
        mode: str = "linear",
        max_seconds: float = 30.0,
        batch_size: int = 32,
        verbose: bool = False,
        embedding_cache: Optional[dict] = None,
    ):
        if (audio_paths is None) == (audios is None):
            raise ValueError("provide exactly one of audio_paths or audios")
        if labels is None or model is None:
            raise ValueError("labels and model must be provided")
        self.audio_paths = list(audio_paths) if audio_paths is not None else None
        self.audios = list(audios) if audios is not None else None
        self.labels = np.asarray(labels)
        self.model = model
        self.sampling_rate = sampling_rate
        self.mode = mode
        self.max_len = int(max_seconds * sampling_rate)
        self.batch_size = batch_size
        self.verbose = verbose
        self.embeddings: Optional[np.ndarray] = None
        self.embedding_cache = embedding_cache
        self._cache_kind = "token" if mode == "attention-pooling" else "clip"
        if precompute_embeddings:
            self._precompute()

    def __len__(self):
        return len(self.labels)

    def _load(self, idx: int) -> np.ndarray:
        if self.audios is not None:
            wav = np.asarray(self.audios[idx], np.float32)
        else:
            wav = load_clip(self.audio_paths[idx], self.sampling_rate)
        return wav[: self.max_len]

    def _cache_key(self, idx: int):
        if self.embedding_cache is None or self.audio_paths is None:
            return None
        return (self.audio_paths[idx], self._cache_kind)

    def _precompute(self):
        """Group clips into batches padded to their longest → one model call
        each."""
        n = len(self)
        out: List[np.ndarray] = [None] * n  # type: ignore
        todo = []
        for i in range(n):
            key = self._cache_key(i)
            if key is not None and key in self.embedding_cache:
                out[i] = self.embedding_cache[key]
            else:
                todo.append(i)
        order = np.asarray(
            sorted(
                todo,
                key=lambda i: -(len(self.audios[i]) if self.audios is not None else 0),
            ),
            np.int64,
        )
        n_todo = len(order)
        for lo in range(0, n_todo, self.batch_size):
            idxs = order[lo : lo + self.batch_size]
            clips = [self._load(int(i)) for i in idxs]
            max_len = max(c.shape[-1] for c in clips)
            padded = [np.pad(c, (0, max_len - c.shape[-1])) for c in clips]
            if hasattr(self.model, "get_batch_embeddings"):
                embs = self.model.get_batch_embeddings(padded, mode=self.mode)
            else:
                embs = [
                    self.model.get_token_embeddings(c)
                    if self.mode == "attention-pooling"
                    else self.model.get_embeddings(c)
                    for c in padded
                ]
            for i, emb in zip(idxs, embs):
                out[int(i)] = np.asarray(emb, np.float32)
                key = self._cache_key(int(i))
                if key is not None:
                    self.embedding_cache[key] = out[int(i)]
            if self.verbose:
                print(
                    f"embeddings {min(lo + self.batch_size, n_todo)}/{n_todo}"
                    f" (+{n - n_todo} cached)",
                    flush=True,
                )
        if self.mode == "attention-pooling":
            max_t = max(e.shape[0] for e in out)
            out = [np.pad(e, ((0, max_t - e.shape[0]), (0, 0))) for e in out]
        self.embeddings = np.stack(out)

    def arrays(self):
        """(X, y) numpy views for the probe trainer."""
        if self.embeddings is None:
            self._precompute()
        return self.embeddings, self.labels


class SequenceClassificationDataset(ClassificationDataset):
    """Frame-level labels: labels[i] is (n_frames,) aligned to the token
    embeddings."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("mode", "attention-pooling")  # token embeddings
        super().__init__(*args, **kwargs)
