"""Synthetic HEAR tasks on disk, in the layout the embeddings runner reads:
``<root>/tasks/<name>/task_metadata.json``, ``labelvocabulary.csv``,
``<split>.json`` and ``<sr>/<split>/*.wav`` (16-bit PCM).

``write_scene_task`` writes a multiclass scene task (one tone a label in
low noise, top-1 accuracy); ``write_event_task`` an event task (tone bursts
in low noise, one in each slot of a clip, onset F-measure and 1-s segment
error rate). Their defaults are the small tasks of the port's tests;
``ESC50_LAYOUT`` and ``DCASE2016_TASK2_LAYOUT`` give the clip counts, clip
lengths, labels and splits of two public HEAR tasks, for timing the harness
at a real task's size. The audio is synthetic in every case.
"""

import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# (split, clips a label) for scene tasks, (split, clips) for event tasks
Splits = Sequence[Tuple[str, int]]

SCENE_GRID = {"lr": [1e-2], "max_epochs": [60], "patience": [20], "check_val_every_n_epoch": [5]}
EVENT_GRID = {"lr": [1e-2], "max_epochs": [30], "patience": [10], "check_val_every_n_epoch": [5]}
EVENT_SECONDS = 0.4  # each tone burst

# ESC-50 (Piczak 2015; HEAR 2021's esc50 task): 2000 clips of 5 s, 50
# classes of 40 clips, 5 predefined folds of 8 clips a class, top-1 accuracy
ESC50_LAYOUT = dict(
    name="esc50_synthetic",
    freqs={f"class{i:02d}": float(100.0 * 2.0 ** (6.0 * i / 49)) for i in range(50)},
    seconds=5.0,
    splits=tuple((f"fold{i:02d}", 8) for i in range(5)),
    split_mode="presplit_kfold",
    grid=None,
)

# DCASE 2016 task 2 as HEAR 2021 holds it (Turian et al. 2022, Table 1):
# 72 clips of 120 s, 11 office-sound labels, train/valid/test, onset
# F-measure; the 36/18/18 division of the 72 clips is this layout's own.
# An event every 4-s slot (30 a clip); the check interval is the
# predictions' task-specific grid for dcase2016_task2
DCASE2016_TASK2_LAYOUT = dict(
    name="dcase2016_task2_synthetic",
    freqs={label: float(150.0 * 2.0 ** (5.0 * i / 10)) for i, label in enumerate(
        ("clearthroat", "cough", "doorslam", "drawer", "keyboard", "keys", "knock",
         "laughter", "pageturn", "phone", "speech"))},
    seconds=120.0,
    splits=(("train", 36), ("valid", 18), ("test", 18)),
    slot_seconds=4.0,
    onsets_ms=tuple(float(ms) for ms in range(0, 3500, 250)),
    grid={"check_val_every_n_epoch": [10]},
)


def _tone(freq: float, seconds: float, sr: int) -> np.ndarray:
    return 0.5 * np.sin(2 * np.pi * freq * np.arange(int(sr * seconds)) / sr)


def _write_wav(path: Path, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sr, (wav * 32000).astype(np.int16))


def _task_dir(root: Path, sr: int, metadata: Dict, labels: Sequence[str],
              grid: Optional[Dict]) -> Path:
    task = Path(root) / "tasks" / metadata["task_name"]
    if grid:
        metadata["evaluation_params"] = {"task_specific_param_grid": grid}
    (task / str(sr)).mkdir(parents=True)
    (task / "task_metadata.json").write_text(json.dumps(metadata))
    (task / "labelvocabulary.csv").write_text(
        "idx,label\n" + "".join(f"{i},{lbl}\n" for i, lbl in enumerate(labels)))
    return task


def write_scene_task(
    root: Path,
    sr: int,
    *,
    name: str = "tones",
    freqs: Optional[Dict[str, float]] = None,
    seconds: float = 1.0,
    splits: Splits = (("train", 8), ("valid", 4), ("test", 4)),
    split_mode: str = "trainvaltest",
    grid: Optional[Dict] = SCENE_GRID,
) -> Path:
    """A multiclass scene task: each clip one label's tone (amplitude 0.5)
    plus noise of σ 0.01; ``splits`` gives the clips a label in each split
    (or fold, for ``split_mode="presplit_kfold"``). Returns the task's
    directory."""
    freqs = freqs or {"low": 30.0, "mid": 120.0, "high": 320.0}
    metadata = {
        "task_name": name, "embedding_type": "scene", "prediction_type": "multiclass",
        "split_mode": split_mode, "splits": [s for s, _ in splits],
        "sample_duration": seconds, "evaluation": ["top1_acc"],
    }
    task = _task_dir(root, sr, metadata, list(freqs), grid)
    rng = np.random.default_rng(0)
    for split, n in splits:
        (task / str(sr) / split).mkdir()
        data = {}
        for label, freq in freqs.items():
            for k in range(n):
                fname = f"{split}_{label}_{k}.wav"
                wav = _tone(freq, seconds, sr) + 0.01 * rng.standard_normal(int(sr * seconds))
                _write_wav(task / str(sr) / split / fname, wav, sr)
                data[fname] = [label]
        (task / f"{split}.json").write_text(json.dumps(data))
    return task


def write_event_task(
    root: Path,
    sr: int,
    *,
    name: str = "bursts",
    freqs: Optional[Dict[str, float]] = None,
    seconds: float = 2.0,
    splits: Splits = (("train", 10), ("valid", 5), ("test", 5)),
    slot_seconds: Optional[float] = None,
    onsets_ms: Sequence[float] = (200.0, 600.0, 1000.0, 1400.0),
    grid: Optional[Dict] = EVENT_GRID,
) -> Path:
    """A multilabel event task: clips of noise (σ 0.002), cut into slots of
    ``slot_seconds`` (one slot a clip by default), each holding one burst
    of ``EVENT_SECONDS`` of a label's tone at an onset drawn from
    ``onsets_ms`` after the slot's start; the label is drawn too where
    there are several. Returns the task's directory."""
    freqs = freqs or {"beep": 120.0}
    labels = list(freqs)
    slot = slot_seconds or seconds
    metadata = {
        "task_name": name, "embedding_type": "event", "prediction_type": "multilabel",
        "split_mode": "trainvaltest", "splits": [s for s, _ in splits],
        "sample_duration": seconds, "evaluation": ["event_onset_200ms_fms", "segment_1s_er"],
    }
    task = _task_dir(root, sr, metadata, labels, grid)
    rng = np.random.default_rng(1)
    for split, n in splits:
        (task / str(sr) / split).mkdir()
        data = {}
        for k in range(n):
            fname = f"{split}_{k}.wav"
            wav = 0.002 * rng.standard_normal(int(sr * seconds))
            events = []
            for s in range(int(round(seconds / slot))):
                start_ms = s * slot * 1000.0 + float(rng.choice(onsets_ms))
                label = labels[0] if len(labels) == 1 else labels[int(rng.integers(len(labels)))]
                lo = int(start_ms / 1000 * sr)
                wav[lo:lo + int(EVENT_SECONDS * sr)] += _tone(freqs[label], EVENT_SECONDS, sr)
                events.append({"label": label, "start": start_ms,
                               "end": start_ms + EVENT_SECONDS * 1000.0})
            _write_wav(task / str(sr) / split / fname, wav, sr)
            data[fname] = events
        (task / f"{split}.json").write_text(json.dumps(data))
    return task


def split_files(task: Path) -> Dict[str, int]:
    """The number of clips in each of a task's splits."""
    metadata = json.loads((Path(task) / "task_metadata.json").read_text())
    return {s: len(json.loads((Path(task) / f"{s}.json").read_text()))
            for s in metadata["splits"]}
