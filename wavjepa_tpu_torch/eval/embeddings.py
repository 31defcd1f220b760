"""HEAR embedding extraction: task dirs → per-split memmap'd embeddings.

The port's copy of ``wavjepa_tpu/eval/embeddings.py``, with its on-disk
contract byte for byte (the same file order from ``random.Random(0)``):

  <embed_task_dir>/
    task_metadata.json, labelvocabulary.csv, {split}.json     (copied in)
    {split}/{file}.embedding.npy [+ .timestamps.json, .target-labels.json]
    {split}.embeddings.npy            float32 memmap (N, dim)
    {split}.embedding-dimensions.json (N, dim)
    {split}.target-labels.pkl
    {split}.filename-timestamps.json  (event tasks)
    profile.embeddings.json, .done.embeddings                 (runner)

A HEAR module's embeddings (torch tensors on its device, or numpy arrays)
come to the host as numpy; audio is decoded by the port's ``data/decode.py``
and resampled by ``data/resample.resample_np``. ``model_options`` (for
example ``{"device": "cpu"}``) go to the module's ``load_model``.
"""

from __future__ import annotations

import importlib
import json
import pickle
import random
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from wavjepa_tpu_torch.data.decode import decode_audio


class Embedding:
    """Wraps an imported HEAR module + loaded model
    (task_embeddings.py:49-96)."""

    def __init__(self, module_name: str, model_path: str = "", model_options: Optional[dict] = None):
        self.module_name = module_name
        self.module = importlib.import_module(module_name)
        self.model = self.module.load_model(model_path, **(model_options or {}))

    @property
    def name(self):
        return self.module_name

    @property
    def sample_rate(self):
        return self.model.sample_rate

    def get_scene_embedding_as_numpy(self, audio: np.ndarray) -> np.ndarray:
        return _to_numpy(self.module.get_scene_embeddings(audio, self.model))

    def get_timestamp_embedding_as_numpy(
        self, audio: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        emb, ts = self.module.get_timestamp_embeddings(audio, self.model)
        return _to_numpy(emb), _to_numpy(ts)


def _to_numpy(x) -> np.ndarray:
    """A torch tensor (on any device) or an array → a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def load_audio_file(path: Path, target_sr: int) -> np.ndarray:
    """Mono f32 waveform at target_sr (HEAR tasks pre-resample audio into
    per-sr directories, so this is a decode, not a resample)."""
    with open(path, "rb") as f:
        data = f.read()
    wav, sr = decode_audio({path.suffix.lstrip("."): data})
    if sr is not None and sr != target_sr:
        from wavjepa_tpu_torch.data.resample import resample_np

        wav = resample_np(wav, sr, target_sr)
    return wav[0] if wav.ndim > 1 else wav


def get_labels_for_timestamps(labels: List, timestamps: np.ndarray) -> List:
    """Per-timestamp label lists via interval containment
    (task_embeddings.py:237-264; the reference uses IntervalTree — a linear
    scan per file is equivalent and dependency-free at HEAR scale)."""
    timestamp_labels = []
    assert len(labels) == len(timestamps)
    for label_events, ts_row in zip(labels, timestamps):
        per_ts = []
        for t in ts_row:
            per_ts.append(
                [
                    e["label"]
                    for e in label_events
                    # reference adds 0.0001 so the end includes the event
                    if e["start"] <= t < e["end"] + 0.0001
                ]
            )
        timestamp_labels.append(per_ts)
    return timestamp_labels


def estimated_batch_size(metadata: Dict, sample_rate: int) -> int:
    """Duration-based batch-size heuristic (task_embeddings.py:416-432)."""
    if metadata.get("sample_duration") is None:
        return 1
    return max(1, int(0.7 * (120 / metadata["sample_duration"]) * (16000 / sample_rate)))


def _iter_batches(split_data: Dict, audio_dir: Path, sr: int, batch_size: int):
    files = list(split_data.keys())
    for i in range(0, len(files), batch_size):
        names = files[i : i + batch_size]
        audios = [load_audio_file(audio_dir / name, sr) for name in names]
        max_len = max(a.shape[-1] for a in audios)
        batch = np.stack(
            [np.pad(a, (0, max_len - a.shape[-1])) for a in audios]
        ).astype(np.float32)
        yield batch, names


def memmap_embeddings(
    outdir: Path,
    prng: random.Random,
    metadata: Dict,
    split_name: str,
    embed_task_dir: Path,
    split_data: Dict,
):
    """Consolidate per-file npy dumps into one float32 memmap + labels pkl
    (+ filename-timestamps for event tasks) — task_embeddings.py:267-373."""
    embedding_files = [outdir / f"{f}.embedding.npy" for f in split_data.keys()]
    prng.shuffle(embedding_files)

    nembeddings, ndim = 0, 0
    for f in embedding_files:
        emb = np.load(f)
        if metadata["embedding_type"] == "scene":
            nembeddings += 1
            ndim = emb.shape[0]
        else:
            nembeddings += emb.shape[0]
            ndim = emb.shape[1]

    (embed_task_dir / f"{split_name}.embedding-dimensions.json").write_text(
        json.dumps((nembeddings, ndim))
    )
    memmap = np.memmap(
        embed_task_dir / f"{split_name}.embeddings.npy",
        dtype=np.float32,
        mode="w+",
        shape=(nembeddings, ndim),
    )
    idx = 0
    labels: List[Any] = []
    filename_timestamps: List[Tuple[str, float]] = []
    for f in embedding_files:
        emb = np.load(f).astype(np.float32)
        lbl = json.loads(
            Path(str(f).replace("embedding.npy", "target-labels.json")).read_text()
        )
        if metadata["embedding_type"] == "scene":
            memmap[idx] = emb
            labels.append(lbl)
            idx += 1
        else:
            memmap[idx : idx + emb.shape[0]] = emb
            labels += lbl
            timestamps = json.loads(
                Path(str(f).replace("embedding.npy", "timestamps.json")).read_text()
            )
            slug = str(f).replace(".embedding.npy", "")
            filename_timestamps += [(slug, t) for t in timestamps]
            idx += emb.shape[0]
    memmap.flush()
    with open(embed_task_dir / f"{split_name}.target-labels.pkl", "wb") as fp:
        pickle.dump(labels, fp)
    if metadata["embedding_type"] == "event":
        (embed_task_dir / f"{split_name}.filename-timestamps.json").write_text(
            json.dumps(filename_timestamps, indent=4)
        )


def task_embeddings(embedding: Embedding, task_path: Path, embed_task_dir: Path):
    """Compute embeddings for every split of one HEAR task
    (task_embeddings.py:376-466)."""
    prng = random.Random()
    prng.seed(0)

    metadata = json.loads((task_path / "task_metadata.json").read_text())
    embed_task_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(task_path / "task_metadata.json", embed_task_dir)
    shutil.copy(task_path / "labelvocabulary.csv", embed_task_dir)

    for split in metadata["splits"]:
        split_path = task_path / f"{split}.json"
        shutil.copy(split_path, embed_task_dir)
        split_data = json.loads(split_path.read_text())
        audio_dir = task_path / str(embedding.sample_rate) / split
        outdir = embed_task_dir / split
        outdir.mkdir(parents=True, exist_ok=True)

        batch_size = estimated_batch_size(metadata, embedding.sample_rate)
        for audios, filenames in _iter_batches(
            split_data, audio_dir, embedding.sample_rate, batch_size
        ):
            labels = [split_data[f] for f in filenames]
            if metadata["embedding_type"] == "scene":
                embs = embedding.get_scene_embedding_as_numpy(audios)
                for i, name in enumerate(filenames):
                    np.save(outdir / f"{name}.embedding.npy", embs[i])
                    (outdir / f"{name}.target-labels.json").write_text(
                        json.dumps(labels[i])
                    )
            elif metadata["embedding_type"] == "event":
                embs, ts = embedding.get_timestamp_embedding_as_numpy(audios)
                ts_labels = get_labels_for_timestamps(labels, ts)
                for i, name in enumerate(filenames):
                    np.save(outdir / f"{name}.embedding.npy", embs[i])
                    (outdir / f"{name}.timestamps.json").write_text(
                        json.dumps(np.asarray(ts[i]).tolist())
                    )
                    (outdir / f"{name}.target-labels.json").write_text(
                        json.dumps(ts_labels[i], indent=4)
                    )
            else:
                raise ValueError(
                    f"Unknown embedding type: {metadata['embedding_type']}"
                )
        memmap_embeddings(outdir, prng, metadata, split, embed_task_dir, split_data)


def device_max_memory_mb() -> Optional[float]:
    """Peak CUDA memory the process allocated (``None`` where no card was
    used); the reference samples the card with pynvml."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / 2**20


def runner(
    module_name: str,
    model_path: str = "",
    tasks_dir: str = "tasks",
    task: str = "all",
    embeddings_dir: str = "embeddings",
    model_options: Optional[dict] = None,
) -> List[Path]:
    """Embeddings CLI body (embeddings/runner.py:48-128): per-task
    idempotency via `.done.embeddings`, stale-dir wipe, timing + device
    memory profile. Returns the list of embed task dirs processed."""
    embedding = Embedding(module_name, model_path, model_options)
    tasks = (
        [p for p in Path(tasks_dir).iterdir() if p.is_dir()]
        if task == "all"
        else [Path(tasks_dir) / task]
    )
    done_dirs = []
    for task_path in tasks:
        embed_dir = Path(embeddings_dir) / embedding.name / task_path.name
        done_file = embed_dir / ".done.embeddings"
        if done_file.exists():
            print(f"{task_path.name}: embeddings already computed", flush=True)
            done_dirs.append(embed_dir)
            continue
        if embed_dir.exists():
            shutil.rmtree(embed_dir)
        start = time.time()
        task_embeddings(embedding, task_path, embed_dir)
        elapsed = time.time() - start
        profile = {
            "time_s": elapsed,
            "device_max_mem_mb": device_max_memory_mb(),
            "module": module_name,
        }
        (embed_dir / "profile.embeddings.json").write_text(json.dumps(profile, indent=4))
        done_file.write_text(json.dumps({"time_s": elapsed}))
        print(f"{task_path.name}: embeddings done in {elapsed:.1f}s", flush=True)
        done_dirs.append(embed_dir)
    return done_dirs
