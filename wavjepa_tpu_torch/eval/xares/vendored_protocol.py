"""The X-ARES task-module protocol, vendored.

The port's copy of ``wavjepa_tpu/eval/xares/vendored_protocol.py``. The
real harness (``python -m xares.run <encoder.py> src/tasks/<task>.py``) is
not installed here; this module holds the task-module interface,
reconstructed from the public xares source (github.com/jimbozhang/xares,
``src/xares/task.py`` and ``src/tasks/*_task.py``), so that the encoder
contract is validated against the protocol a real task module drives:

  1. ``xares.run`` imports the encoder module file and finds the encoder
     class by inspection, the one ``nn.Module`` subclass defined in that
     module (``discover_encoder_class``);
  2. a task module has a ``config_<name>(encoder) -> TaskConfig`` factory;
     ``TaskConfig`` carries the protocol's settings (splits or folds, crop
     length, probe learning rate, batch and epochs, ``label_processor``,
     the primary ``metric``);
  3. the harness validates the encoder (``checker.py``), encodes each split
     at ``encoder.sampling_rate`` with ``crop_length_s`` cropping,
     mean-pools the frames of clip-level tasks, trains a probe, and reports
     the configured metric, with an unsupervised kNN leg beside it.

``run_task_protocol`` runs step 3 end to end on in-memory splits. The
probes and the kNN leg run on ``cuda`` unless ``device="cpu"`` is given.
Field names and defaults are a reconstruction of the public source: the
protocol, not an import-compatible copy.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from wavjepa_tpu_torch.api.runtime import DeviceLike, resolve_device
from wavjepa_tpu_torch.eval.score import binary_average_precision


@dataclasses.dataclass
class TaskConfig:
    """Interface reconstruction of ``xares.task.TaskConfig`` (public
    source): the knobs every src/tasks/*_task.py factory sets."""

    encoder: Any
    name: str
    formal_name: str = ""
    metric: str = "accuracy"
    output_dim: Optional[int] = None  # number of classes / labels
    label_processor: Optional[Callable[[dict], Any]] = None
    # data identity + splits
    zenodo_id: str = ""
    train_split: str = "train"
    valid_split: str = "valid"
    test_split: str = "test"
    k_fold_splits: Optional[Sequence[Any]] = None
    use_mini_dataset: bool = False
    # encode / probe protocol
    crop_length_s: Optional[float] = None
    batch_size_encode: int = 16
    batch_size_train: int = 32
    learning_rate: float = 1e-3
    epochs: int = 10
    do_knn: bool = True
    eval_weight: int = 0  # task weight in the published aggregate

    def __post_init__(self):
        if not self.formal_name:
            self.formal_name = self.name


def config_esc50(encoder) -> TaskConfig:
    """Vendored fixture of src/tasks/esc50_task.py's factory: ESC-50 is a
    50-class, 5-fold, 5-second clip-level task."""
    return TaskConfig(
        encoder=encoder,
        name="esc50",
        formal_name="ESC-50",
        metric="accuracy",
        output_dim=50,
        label_processor=lambda sample: sample["label"],
        zenodo_id="zenodo.1234567",  # placeholder: data ids are not protocol
        k_fold_splits=[1, 2, 3, 4, 5],
        crop_length_s=5.0,
        batch_size_train=32,
        learning_rate=1e-3,
        epochs=10,
    )


def config_fsd50k(encoder) -> TaskConfig:
    """Vendored fixture of src/tasks/fsd50k_task.py's factory: FSD50K is a
    200-class MULTILABEL clip-level task scored by macro mAP. The
    label_processor maps a sample's label list to a multi-hot vector (the
    published task modules do the same via label_to_binary_vector); the kNN
    leg is off — kNN majority vote is undefined for multilabel targets."""
    n_classes = 200

    def to_multihot(sample: dict) -> np.ndarray:
        vec = np.zeros((n_classes,), np.float32)
        vec[np.asarray(sample["labels"], np.int64)] = 1.0
        return vec

    return TaskConfig(
        encoder=encoder,
        name="fsd50k",
        formal_name="FSD50K",
        metric="mAP",
        output_dim=n_classes,
        label_processor=to_multihot,
        zenodo_id="zenodo.4060432",  # placeholder: data ids are not protocol
        crop_length_s=10.0,
        batch_size_train=32,
        learning_rate=1e-3,
        epochs=10,
        do_knn=False,
    )


def knn_classify(
    x_tr: np.ndarray, y_tr: np.ndarray, x_te: np.ndarray, k: int = 10,
    device: DeviceLike = None,
) -> np.ndarray:
    """The unsupervised kNN leg the harness reports beside the probe
    (xares ``run_knn``): cosine similarity of L2-normalised embeddings, the
    majority of the k nearest train items' labels, the lowest label among
    equal counts. Returns the predicted integer labels of x_te."""
    dev = resolve_device(device)
    k = min(k, len(y_tr))
    dtype = np.result_type(x_tr, x_te, np.float32)
    a = torch.from_numpy(np.asarray(x_tr, dtype)).to(dev)
    b = torch.from_numpy(np.asarray(x_te, dtype)).to(dev)
    a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-12)
    nearest = (b @ a.T).topk(k, dim=1).indices  # (n_te, k)
    votes = torch.from_numpy(np.asarray(y_tr, np.int64)).to(dev)[nearest]
    counts = F.one_hot(votes, int(np.max(y_tr)) + 1).sum(dim=1)
    return counts.argmax(dim=1).cpu().numpy()


def discover_encoder_class(encoder_py: str | Path) -> type:
    """Import an encoder module file and find the encoder class the way
    `xares.run` does: the torch.nn.Module subclass DEFINED in that module."""
    encoder_py = Path(encoder_py)
    spec = importlib.util.spec_from_file_location(encoder_py.stem, encoder_py)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    candidates = [
        obj
        for _, obj in inspect.getmembers(module, inspect.isclass)
        if issubclass(obj, torch.nn.Module)
        and obj.__module__ == module.__name__
    ]
    if len(candidates) != 1:
        raise ValueError(
            f"{encoder_py} must define exactly one nn.Module encoder class, "
            f"found {[c.__name__ for c in candidates]}"
        )
    return candidates[0]


def _crop_or_pad(wav: np.ndarray, n: int) -> np.ndarray:
    if wav.shape[-1] >= n:
        return wav[..., :n]
    return np.pad(wav, (0, n - wav.shape[-1]))


def encode_split(config: TaskConfig, samples: Sequence[dict]) -> tuple:
    """Encode a split as XaresTask.make_encoded_tar drives the encoder:
    batches of (B, crop_samples) float32 at encoder.sampling_rate → frame
    embeddings → clip-level mean pool on the encoder's device. Labels via
    config.label_processor."""
    enc = config.encoder
    sr = enc.sampling_rate
    crop = int(sr * config.crop_length_s) if config.crop_length_s else None
    xs, ys = [], []
    for i in range(0, len(samples), config.batch_size_encode):
        batch = samples[i : i + config.batch_size_encode]
        wavs = [np.asarray(s["audio"], np.float32) for s in batch]
        n = crop if crop else max(w.shape[-1] for w in wavs)
        stacked = np.stack([_crop_or_pad(w, n) for w in wavs])
        with torch.inference_mode():
            emb = enc(torch.from_numpy(stacked))  # (B, T', D)
            assert emb.dim() == 3 and emb.shape[2] == enc.output_dim
            xs.append(emb.mean(dim=1).float().cpu().numpy())
        ys.extend(config.label_processor(s) for s in batch)
    return np.concatenate(xs), np.asarray(ys)


def _train_probe_multilabel(
    x: np.ndarray, y: np.ndarray, steps: int = 300, lr: float = 1e-2, seed: int = 0,
    device: DeviceLike = None,
):
    """Linear probe under sigmoid BCE, the multilabel twin of
    ``run._train_probe`` (the xares probe uses BCEWithLogits for
    metric='mAP' tasks). y is multi-hot (N, C) float."""
    from wavjepa_tpu_torch.eval.xares.run import _fit_probe, _init_probe

    w, b = _init_probe(x.shape[1], y.shape[1], seed)
    return _fit_probe(x, np.asarray(y, np.float32), w, b, F.binary_cross_entropy_with_logits,
                      steps, lr, device)


def mean_average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """Macro mAP over the classes with at least one positive, by
    scikit-learn's ``average_precision_score`` (``eval/score.py``: tied
    scores grouped into one threshold), as the JAX package computes it
    where scikit-learn is installed. Its numpy fallback, taken without
    scikit-learn, ranks tied scores one by one in a stable order and so
    differs on ties."""
    keep = targets.sum(0) > 0
    return float(np.mean([binary_average_precision(targets[:, c], scores[:, c])
                          for c in np.flatnonzero(keep)]))


def run_task_protocol(config: TaskConfig, splits: dict, device: DeviceLike = None) -> dict:
    """Drive the full task protocol on in-memory splits
    ({split_name: [ {audio, label(s)}, ... ]}): encode each split, train the
    probe on train, report config.metric on test, and the unsupervised kNN
    leg when ``config.do_knn`` (single-label tasks only, as in the published
    harness). Returns the result record shaped like the harness's output."""
    from wavjepa_tpu_torch.eval.xares.checker import check_audio_encoder
    from wavjepa_tpu_torch.eval.xares.run import _train_probe

    dev = resolve_device(device)
    check_audio_encoder(config.encoder)
    x_tr, y_tr = encode_split(config, splits[config.train_split])
    x_te, y_te = encode_split(config, splits[config.test_split])
    steps = max(50, config.epochs * 30)

    if config.metric == "accuracy":
        classes = sorted(set(y_tr) | set(y_te))
        cls_to_idx = {c: i for i, c in enumerate(classes)}
        y_tr_i = np.asarray([cls_to_idx[c] for c in y_tr])
        y_te_i = np.asarray([cls_to_idx[c] for c in y_te])
        params, (mu, sd), _ = _train_probe(
            x_tr, y_tr_i, len(classes), lr=config.learning_rate, steps=steps, device=dev
        )
        logits = (x_te - mu) / sd @ params[0] + params[1]
        value = float((logits.argmax(-1) == y_te_i).mean())
        n_train, n_test = len(y_tr_i), len(y_te_i)
        knn_value = (
            float((knn_classify(x_tr, y_tr_i, x_te, device=dev) == y_te_i).mean())
            if config.do_knn
            else None
        )
    elif config.metric == "mAP":
        # multilabel: label_processor produced multi-hot rows (N, C)
        y_tr_m = np.asarray(y_tr, np.float32)
        y_te_m = np.asarray(y_te, np.float32)
        params, (mu, sd), _ = _train_probe_multilabel(
            x_tr, y_tr_m, lr=config.learning_rate, steps=steps, device=dev
        )
        logits = (x_te - mu) / sd @ params[0] + params[1]
        value = mean_average_precision(logits, y_te_m)
        n_train, n_test = len(y_tr_m), len(y_te_m)
        knn_value = None  # kNN majority vote is undefined for multilabel
    else:
        raise NotImplementedError(
            f"the protocol covers accuracy and mAP; got {config.metric}"
        )
    result = {
        "task": config.name,
        "formal_name": config.formal_name,
        "metric": config.metric,
        "value": value,
        "n_train": n_train,
        "n_test": n_test,
    }
    if knn_value is not None:
        result["knn_accuracy"] = knn_value
    return result
