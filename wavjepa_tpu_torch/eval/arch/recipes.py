"""ARCH task recipes: dataset loaders and the evaluation protocol of the 12
ARCH classification benchmarks.

The port's copy of ``wavjepa_tpu/eval/arch/recipes.py``: each recipe
parses its dataset's native metadata layout into folds or fixed splits,
then a shared evaluator runs the probe protocol (linear / non-linear /
attention-pooling ``ClassificationProbe``, AdamW with warmup and decay,
best by validation loss) with the mean and deviation over the folds.

The metadata is read with the standard library (``csv``, ``json``), not
pandas, to the same result:

  * a CSV column is typed as pandas types it: integers if every value is
    one, else floats if every value is one (an integer column with a
    missing value too), else strings; pandas' missing-value markers are
    missing (``nan``);
  * FMA-small's ``tracks.csv`` has a two-row header and its track ids as
    the index, under which a row naming the index may stand;
  * MagnaTagATune's top 50 tags are ordered as pandas'
    ``sort_values(ascending=False)`` orders them, which is not stable: the
    reversed counts through numpy's quicksort, reversed again, so tags tied
    at the 50th place fall as they do in the JAX package;
  * ``_train_val_split`` is scikit-learn's ``train_test_split(...,
    random_state=42)``: ceil(test_size · n) test items, the rest train,
    from ``np.random.RandomState(42).permutation(n)``.

Fold datasets (an 80/20 train/val split inside each training set): ESC-50,
US8K, VIVAE (speaker folds), AudioMNIST (speaker folds), EMOVO (speaker
folds). Fixed-split datasets: FSD50K (dev/eval), FMA-small, MagnaTagATune
(tsv splits), IRMAS (train/test parts), MedleyDB (metadata subsets),
RAVDESS (random 64/16/20), SLURP (jsonl splits).

The probes run on ``cuda`` unless ``evaluate`` is given ``device="cpu"``.
"""

from __future__ import annotations

import csv
import glob
import json
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wavjepa_tpu_torch.api.runtime import DeviceLike
from wavjepa_tpu_torch.eval.arch.datasets import ClassificationDataset
from wavjepa_tpu_torch.eval.arch.model import Model
from wavjepa_tpu_torch.eval.arch.probes import ClassificationProbe

# pandas.read_csv's default missing-value markers
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"\s*[+-]?\d+\s*")


def _float(v: str) -> Optional[float]:
    """float(v), or None where pandas reads no number (Python's float takes
    digit groups with underscores too)."""
    try:
        return None if "_" in v else float(v)
    except ValueError:
        return None


def _typed(values: Sequence[str]) -> list:
    """A column's strings typed as pandas types them: int, float or str,
    missing values ``nan``."""
    nan = float("nan")
    present = [v for v in values if v not in _NA]
    if present and all(_INT.fullmatch(v) for v in present):
        if len(present) == len(values):
            return [int(v) for v in values]
        return [nan if v in _NA else float(int(v)) for v in values]
    floats = [_float(v) for v in present]
    if present and None not in floats:
        return [nan if v in _NA else _float(v) for v in values]
    return [nan if v in _NA else v for v in values]


def _read_table(path: str, sep: str = ",", header: bool = True
                ) -> Tuple[List, Dict[object, list]]:
    """A delimited file → (column names, {name: typed values}); without a
    header the columns are named 0, 1, …."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    names = rows.pop(0) if header else list(range(max(len(r) for r in rows)))
    cols = {name: _typed([r[i] if i < len(r) else "" for r in rows])
            for i, name in enumerate(names)}
    return names, cols


def _n_unique(values: list) -> int:
    """pandas' ``nunique``: distinct values, missing ones not counted."""
    return len({v for v in values if not (isinstance(v, float) and math.isnan(v))})


def _sort_descending(values: np.ndarray) -> np.ndarray:
    """The order of pandas' ``Series.sort_values(ascending=False)``
    (``nargsort``): the reversed values through numpy's quicksort, whose
    order of ties is not the input's, reversed back."""
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind="quicksort")][::-1]


def _train_val_split(paths, labels, test_size=0.2, seed=42):
    """scikit-learn's ``train_test_split(paths, labels, test_size=test_size,
    random_state=seed)`` of two lists → (train_paths, test_paths,
    train_labels, test_labels), each a list."""
    n = len(paths)
    if len(labels) != n:
        raise ValueError(f"paths and labels differ in length: {n} and {len(labels)}")
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in (0, 1)")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, the "
            "resulting train set will be empty. Adjust any of the aforementioned parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return [[a[i] for i in idx] for a in (paths, labels) for idx in (train, test)]


def resolve_audio_path(path: str) -> str:
    """Prefer a transcoded .wav/.flac sibling for formats the first-party
    decoder does not handle (mp3: FMA-small and MagnaTagATune ship mp3;
    ``data/decode.py`` asks for a one-time transcode). Returns the original
    path when no sibling exists so the decoder's transcode advice surfaces."""
    base, ext = os.path.splitext(path)
    if ext.lower() != ".mp3":
        return path
    for alt in (base + ".wav", base + ".flac"):
        if os.path.exists(alt):
            return alt
    return path


class _RecipeBase:
    is_multilabel: bool = False
    num_classes: int = 0

    def _all_audio_paths(self) -> List[str]:
        if hasattr(self, "folds"):
            paths: List[str] = []
            for fold in self.folds.values():
                paths += fold["audio_paths"]
            return sorted(set(paths))
        return sorted(
            {p for split in self.splits.values() for p in split[0]}
        )

    def get_average_duration(self) -> float:
        """Mean clip duration in seconds."""
        from wavjepa_tpu_torch.eval.arch.datasets import load_clip

        durations = []
        for path in self._all_audio_paths():
            try:
                durations.append(load_clip(path, 16000).shape[-1] / 16000.0)
            except Exception as exc:
                print(f"{path}: {exc}")
        return float(np.mean(durations)) if durations else 0.0

    def _probe_layers(self, model: Model, mode: str) -> List[int]:
        if mode == "non-linear":
            return [model.get_classification_embedding_size()]
        return []

    def _fit_eval(
        self,
        model: Model,
        mode: str,
        train, val, test,  # (paths-or-audios, labels) triples
        max_num_epochs: int,
        batch_size: int,
        learning_rate: float = 1e-3,
        device: DeviceLike = None,
        **kwargs,
    ) -> Dict[str, float]:
        cache = getattr(self, "_embedding_cache", None)
        if cache is None:
            cache = self._embedding_cache = {}

        def make(split):
            return ClassificationDataset(
                audio_paths=split[0],
                labels=split[1],
                model=model,
                sampling_rate=model.get_sampling_rate(),
                embedding_cache=cache,
                precompute_embeddings=getattr(self, "precompute_embeddings", True),
                mode=mode,
                batch_size=batch_size,
            ).arrays()

        probe = ClassificationProbe(
            layers=self._probe_layers(model, mode),
            input_embedding_size=model.get_classification_embedding_size(),
            num_classes=self.num_classes,
            is_multilabel=self.is_multilabel,
            mode=mode,
            device=device,
        )
        probe.train(
            make(train), make(val),
            learning_rate=learning_rate,
            max_num_epochs=max_num_epochs, batch_size=batch_size,
        )
        return probe.evaluate(make(test))

    @staticmethod
    def _aggregate(fold_results: Dict) -> Dict[str, float]:
        keys = next(iter(fold_results.values())).keys()
        out = {}
        for key in keys:
            vals = [r[key] for r in fold_results.values()]
            out[key] = float(np.mean(vals))
            out[f"{key}_std"] = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
        return out


class _FoldedRecipe(_RecipeBase):
    """Fold-based leave-one-fold-out evaluation."""

    def __init__(self, path: str, verbose: bool = False, precompute_embeddings: bool = True):
        self.path = path
        self.verbose = verbose
        self.precompute_embeddings = precompute_embeddings
        self.folds = self._load_folds()

    def _load_folds(self) -> Dict:
        raise NotImplementedError

    def evaluate(
        self,
        model: Model,
        mode: str = "linear",
        device: DeviceLike = None,
        batch_size: int = 32,
        max_num_epochs: int = 100,
        **kwargs,
    ) -> Dict[str, float]:
        results = {}
        for fold in self.folds:
            train_paths, train_labels, test_paths, test_labels = [], [], [], []
            for other in self.folds:
                if other == fold:
                    test_paths += self.folds[other]["audio_paths"]
                    test_labels += list(self.folds[other]["labels"])
                else:
                    train_paths += self.folds[other]["audio_paths"]
                    train_labels += list(self.folds[other]["labels"])
            tr_p, va_p, tr_l, va_l = _train_val_split(train_paths, train_labels)
            results[fold] = self._fit_eval(
                model, mode,
                (tr_p, tr_l), (va_p, va_l), (test_paths, test_labels),
                max_num_epochs, batch_size, device=device, **kwargs,
            )
            if self.verbose:
                print(f"fold {fold}: {results[fold]}", flush=True)
        return self._aggregate(results)


class _SplitRecipe(_RecipeBase):
    """Fixed train/val/test evaluation."""

    def __init__(self, path: str, verbose: bool = False, precompute_embeddings: bool = True):
        self.path = path
        self.verbose = verbose
        self.precompute_embeddings = precompute_embeddings
        self.splits = self._load_splits()  # {split: (paths, labels)}

    def _load_splits(self) -> Dict:
        raise NotImplementedError

    def evaluate(
        self,
        model: Model,
        mode: str = "linear",
        device: DeviceLike = None,
        batch_size: int = 32,
        max_num_epochs: int = 100,
        **kwargs,
    ) -> Dict[str, float]:
        return self._fit_eval(
            model, mode,
            self.splits["train"], self.splits["valid"], self.splits["test"],
            max_num_epochs, batch_size, device=device, **kwargs,
        )


def _folds_from_table(cols: Dict, path_of, **fields: str) -> Dict:
    """{fold: {"audio_paths", <field>: the values of column ``fields[field]``}}
    over the sorted distinct values of the ``fold`` column, rows in the
    file's order."""
    folds = {}
    for fold in sorted(set(cols["fold"])):
        rows = [i for i, f in enumerate(cols["fold"]) if f == fold]
        folds[int(fold)] = {"audio_paths": [path_of(fold, i) for i in rows]}
        folds[int(fold)].update({field: [cols[col][i] for i in rows]
                                 for field, col in fields.items()})
    return folds


# ================================================================== sound


class ESC50(_FoldedRecipe):
    """ESC-50: 5 folds from meta/esc50.csv."""

    def _load_folds(self):
        _, meta = _read_table(os.path.join(self.path, "meta", "esc50.csv"))
        self.num_classes = _n_unique(meta["target"])
        return _folds_from_table(
            meta, lambda fold, i: os.path.join(self.path, "audio", meta["filename"][i]),
            labels="target", readable_labels="category")


class US8K(_FoldedRecipe):
    """UrbanSound8K: 10 folds from metadata/UrbanSound8K.csv."""

    def _load_folds(self):
        _, meta = _read_table(os.path.join(self.path, "metadata", "UrbanSound8K.csv"))
        self.num_classes = _n_unique(meta["classID"])
        return _folds_from_table(
            meta, lambda fold, i: os.path.join(self.path, "audio", f"fold{fold}",
                                               meta["slice_file_name"][i]),
            labels="classID")


class VIVAE(_FoldedRecipe):
    """VIVAE: speaker folds over full_set/S<spk>_<emotion>_*.wav."""

    def _load_folds(self):
        paths = sorted(glob.glob(os.path.join(self.path, "full_set", "*.wav")))
        emotions = sorted({os.path.basename(p).split("_")[1] for p in paths})
        self.emotion_map = {e: i for i, e in enumerate(emotions)}
        self.num_classes = len(emotions)
        folds: Dict = {}
        for p in paths:
            base = os.path.basename(p)
            speaker = base.split("_")[0].replace("S", "")
            emotion = base.split("_")[1]
            fold = folds.setdefault(
                speaker, {"audio_paths": [], "labels": []}
            )
            fold["audio_paths"].append(p)
            fold["labels"].append(self.emotion_map[emotion])
        return folds


class FSD50K(_SplitRecipe):
    """FSD50K: multilabel; dev.csv train/val markers + eval.csv test."""

    is_multilabel = True

    def _load_splits(self):
        gt = os.path.join(self.path, "FSD50K.ground_truth")
        _, dev = _read_table(os.path.join(gt, "dev.csv"))
        _, test = _read_table(os.path.join(gt, "eval.csv"))
        all_labels = sorted(
            {
                label
                for labels in list(dev["labels"]) + list(test["labels"])
                for label in str(labels).split(",")
            }
        )
        self.label_map = {l: i for i, l in enumerate(all_labels)}
        self.num_classes = len(all_labels)

        def vecs(table, rows, audio_dir):
            paths, ys = [], []
            for i in rows:
                paths.append(
                    os.path.join(self.path, audio_dir, f"{table['fname'][i]}.wav")
                )
                y = np.zeros((self.num_classes,), np.float32)
                for label in str(table["labels"][i]).split(","):
                    y[self.label_map[label]] = 1.0
                ys.append(y)
            return paths, np.stack(ys)

        def where(split):
            return [i for i, s in enumerate(dev["split"]) if s == split]

        return {
            "train": vecs(dev, where("train"), "FSD50K.dev_audio"),
            "valid": vecs(dev, where("val"), "FSD50K.dev_audio"),
            "test": vecs(test, range(len(test["fname"])), "FSD50K.eval_audio"),
        }


# ================================================================== music


def _read_fma_tracks(path: str) -> Tuple[list, Dict[Tuple[str, str], list]]:
    """FMA's ``tracks.csv`` as ``pd.read_csv(index_col=0, header=[0, 1])``
    reads it → (track ids, {(level 0, level 1): typed values}). A row after
    the two header rows that names the index and nothing else (FMA's
    ``track_id,,,…``) is the index's name, not a track."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    top, sub, rows = rows[0], rows[1], rows[2:]
    if rows and rows[0][0] and not any(rows[0][1:]):
        rows = rows[1:]
    index = _typed([r[0] for r in rows])
    cols = {(top[i], sub[i]): _typed([r[i] if i < len(r) else "" for r in rows])
            for i in range(1, len(top))}
    return index, cols


class FMASmall(_SplitRecipe):
    """FMA-small: genre classification; tracks.csv metadata + mp3 tree,
    80/10/10 random split."""

    def __init__(self, config_path: str, audio_files_path: str, verbose: bool = False,
                 precompute_embeddings: bool = True):
        self.config_path = config_path
        self.audio_files_path = audio_files_path
        self.path = audio_files_path
        self.verbose = verbose
        self.splits = self._load_splits()

    def _load_splits(self):
        index, tracks = _read_fma_tracks(os.path.join(self.config_path, "tracks.csv"))
        small = [i for i, s in enumerate(tracks[("set", "subset")]) if s == "small"]
        genres = [str(tracks[("track", "genre_top")][i]) for i in small]
        labels_list = sorted(set(genres))
        self.label_map = {g: i for i, g in enumerate(labels_list)}
        self.num_classes = len(labels_list)
        paths = [
            resolve_audio_path(
                os.path.join(
                    self.audio_files_path,
                    str(index[i])[:3].zfill(3),
                    str(index[i]).zfill(6) + ".mp3",
                )
            )
            for i in small
        ]
        labels = [self.label_map[g] for g in genres]
        tr_p, te_p, tr_l, te_l = _train_val_split(paths, labels, test_size=0.2)
        te_p, va_p, te_l, va_l = _train_val_split(te_p, te_l, test_size=0.5)
        return {"train": (tr_p, tr_l), "valid": (va_p, va_l), "test": (te_p, te_l)}


class MagnaTagATune(_SplitRecipe):
    """MagnaTagATune: top-50-tag multilabel; annotations_final.csv +
    {train,val,test}_gt_mtt.tsv id lists."""

    is_multilabel = True
    TOP_TAGS = 50

    def _load_splits(self):
        names, df = _read_table(os.path.join(self.path, "annotations_final.csv"), sep="\t")
        tag_cols = [c for c in names if c not in ("clip_id", "mp3_path")]
        tags = np.array([df[c] for c in tag_cols]).T  # (clips, tags), int64
        top = [tag_cols[i] for i in _sort_descending(tags.sum(axis=0))[: self.TOP_TAGS]]
        self.label_names = top
        self.num_classes = len(top)
        top_idx = [tag_cols.index(t) for t in top]
        by_id = {}
        for row, cid in enumerate(df["clip_id"]):
            by_id.setdefault(cid, row)

        def split(name):
            _, ids = _read_table(os.path.join(self.path, f"{name}_gt_mtt.tsv"), sep="\t",
                                 header=False)
            paths, ys = [], []
            for cid in ids[0]:
                if cid not in by_id:
                    continue
                row = by_id[cid]
                paths.append(
                    resolve_audio_path(os.path.join(self.path, str(df["mp3_path"][row])))
                )
                ys.append(tags[row, top_idx].astype(np.float32))
            return paths, np.stack(ys)

        return {"train": split("train"), "valid": split("val"), "test": split("test")}


class IRMAS(_SplitRecipe):
    """IRMAS: instrument recognition; training folders per instrument,
    multilabel txt annotations for test parts."""

    is_multilabel = True

    def _load_splits(self):
        train_dirs = sorted(
            d
            for d in glob.glob(os.path.join(self.path, "IRMAS-TrainingData", "*"))
            if os.path.isdir(d)
        )
        instruments = sorted(os.path.basename(d) for d in train_dirs)
        self.label_map = {ins: i for i, ins in enumerate(instruments)}
        self.num_classes = len(instruments)

        train_paths, train_ys = [], []
        for ins in instruments:
            for p in sorted(
                glob.glob(os.path.join(self.path, "IRMAS-TrainingData", ins, "*.wav"))
            ):
                y = np.zeros((self.num_classes,), np.float32)
                y[self.label_map[ins]] = 1.0
                train_paths.append(p)
                train_ys.append(y)
        test_paths, test_ys = [], []
        for part in ("Part1", "Part2", "Part3"):
            for p in sorted(
                glob.glob(
                    os.path.join(self.path, f"IRMAS-TestingData-{part}", part, "*.wav")
                )
            ):
                y = np.zeros((self.num_classes,), np.float32)
                with open(p.replace(".wav", ".txt")) as f:
                    for line in f:
                        label = line.strip()
                        if label in self.label_map:
                            y[self.label_map[label]] = 1.0
                test_paths.append(p)
                test_ys.append(y)
        tr_p, va_p, tr_y, va_y = _train_val_split(train_paths, train_ys)
        return {
            "train": (tr_p, np.stack(tr_y)),
            "valid": (va_p, np.stack(va_y)),
            "test": (test_paths, np.stack(test_ys)),
        }


class MedleyDB(_SplitRecipe):
    """Medley-solos-DB: instrument classification with predefined subsets in
    Medley-solos-DB_metadata.csv."""

    def _load_splits(self):
        _, meta = _read_table(os.path.join(self.path, "Medley-solos-DB_metadata.csv"))
        self.num_classes = _n_unique(meta["instrument_id"])
        audio_dir = os.path.join(self.path, "audio")
        all_paths = glob.glob(os.path.join(audio_dir, "*.wav"))
        by_uuid = {}
        for p in all_paths:
            # Medley-solos-DB_<subset>-<instrument_id>_<uuid>.wav
            uuid = os.path.basename(p).rsplit("_", 1)[-1].replace(".wav", "")
            by_uuid[uuid] = p
        splits = {"train": ("training",), "valid": ("validation",), "test": ("test",)}
        out = {}
        for name, subsets in splits.items():
            paths, labels = [], []
            for i, subset in enumerate(meta["subset"]):
                if subset not in subsets:
                    continue
                p = by_uuid.get(str(meta["uuid4"][i]))
                if p is not None:
                    paths.append(p)
                    labels.append(int(meta["instrument_id"][i]))
            out[name] = (paths, labels)
        return out


# ================================================================== speech


class RAVDESS(_SplitRecipe):
    """RAVDESS: emotion from filename field 3; random 64/16/20 split with
    seed 42."""

    def _load_splits(self):
        paths = sorted(
            glob.glob(os.path.join(self.path, "**", "*.wav"), recursive=True)
        )
        labels = [int(os.path.basename(p).split("-")[2]) - 1 for p in paths]
        self.num_classes = len(set(labels))
        tr_p, te_p, tr_l, te_l = _train_val_split(paths, labels, test_size=0.2)
        tr_p, va_p, tr_l, va_l = _train_val_split(tr_p, tr_l, test_size=0.2)
        return {"train": (tr_p, tr_l), "valid": (va_p, va_l), "test": (te_p, te_l)}


class AudioMNIST(_FoldedRecipe):
    """AudioMNIST: digit classification, 5 speaker-group folds."""

    SPEAKER_FOLDS = [
        list(range(1, 13)),
        list(range(13, 25)),
        list(range(25, 37)),
        list(range(37, 49)),
        list(range(49, 61)),
    ]

    def _load_folds(self):
        self.num_classes = 10
        files = sorted(glob.glob(os.path.join(self.path, "data", "*", "*.wav")))
        folds = {}
        for fold_id, speakers in enumerate(self.SPEAKER_FOLDS):
            speaker_set = {f"{s:02d}" for s in speakers}
            fold = {"audio_paths": [], "labels": []}
            for p in files:
                digit, speaker, _ = os.path.basename(p).split("_")
                if speaker in speaker_set:
                    fold["audio_paths"].append(p)
                    fold["labels"].append(int(digit))
            folds[fold_id] = fold
        return folds


class SLURP(_SplitRecipe):
    """SLURP: intent (scenario_action) classification from
    {train,devel,test}.jsonl."""

    def __init__(self, path: str, audio_dir: str = "slurp_real", **kwargs):
        self.audio_dir = audio_dir
        super().__init__(path, **kwargs)

    def _load_splits(self):
        def read_jsonl(name):
            rows = []
            with open(os.path.join(self.path, name)) as f:
                for line in f:
                    rows.append(json.loads(line))
            return rows

        splits_raw = {
            "train": read_jsonl("train.jsonl"),
            "valid": read_jsonl("devel.jsonl"),
            "test": read_jsonl("test.jsonl"),
        }
        intents = sorted(
            {
                f"{r['scenario']}_{r['action']}"
                for rows in splits_raw.values()
                for r in rows
            }
        )
        self.label_map = {x: i for i, x in enumerate(intents)}
        self.all_labels = intents
        self.num_classes = len(intents)
        out = {}
        for name, rows in splits_raw.items():
            paths, labels = [], []
            for r in rows:
                intent = self.label_map[f"{r['scenario']}_{r['action']}"]
                for rec in r.get("recordings", []):
                    paths.append(
                        os.path.join(self.path, self.audio_dir, rec["file"])
                    )
                    labels.append(intent)
            out[name] = (paths, labels)
        return out


class EMOVO(_FoldedRecipe):
    """EMOVO: emotion classification, one fold per speaker; labels from
    <label>-<speaker>-<number>.wav."""

    def _load_folds(self):
        speaker_dirs = sorted(
            d
            for d in glob.glob(os.path.join(self.path, "EMOVO", "*"))
            if os.path.isdir(d)
        )
        label_set = set()
        raw = {}
        for d in speaker_dirs:
            speaker = os.path.basename(d)
            files = sorted(glob.glob(os.path.join(d, "*.wav")))
            labels = [os.path.basename(f).split("-")[0] for f in files]
            label_set |= set(labels)
            raw[speaker] = (files, labels)
        self.label_map = {l: i for i, l in enumerate(sorted(label_set))}
        self.num_classes = len(self.label_map)
        return {
            speaker: {
                "audio_paths": files,
                "labels": [self.label_map[l] for l in labels],
            }
            for speaker, (files, labels) in raw.items()
        }
