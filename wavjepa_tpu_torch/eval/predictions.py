"""HEAR downstream prediction: shallow-probe training over precomputed
embeddings with random grid search, score-based early stopping, and event
postprocessing search.

The port's copy of ``wavjepa_tpu/eval/predictions.py``, with the probe in
torch instead of flax/optax and every protocol decision kept:

  * ``FullyConnectedProbe``: 0-2 hidden layers (Linear → BatchNorm →
    Dropout → ReLU), xavier init at the preceding activation's gain, zero
    biases, sigmoid + BCE for multilabel and softmax + cross-entropy for
    multiclass, ``torch.optim.Adam`` (optax's ``adam``: the same update);
  * the BatchNorm is flax's: normalised by the batch's biased variance
    (E[x²] − E[x]²), and its running variance updated with that biased
    variance (momentum 0.1 of the batch, flax's 0.9 of the average);
    ``nn.BatchNorm1d``, and hear-eval-kit's probe, update it with the
    unbiased one;
  * dropout draws from an explicit ``torch.Generator`` on the probe's
    device, seeded from the task seed;
  * PARAM_GRID and its fast/faster variants, random-shuffled, the first
    ``grid_points`` tried; early stopping on the primary score (validation
    every ``check_val_every_n_epoch`` epochs, patience counted in
    validation events, the best epoch's weights restored for test);
  * batches in the order of ``np.random.default_rng(seed).permutation``, an
    epoch at a time, as the JAX package draws them;
  * event tasks: per-validation postprocessing grid search (median filter
    + min duration), the best frozen at the best epoch and reused at test;
  * LOOCV fold splits, per-fold test, mean/std aggregation,
    test.predicted-scores.json.

The probe trains on ``cuda`` unless ``device="cpu"`` is given; with no card
it raises. ``probe_state_dict_from_jax`` carries a flax probe's parameters
and batch statistics into it.
"""

from __future__ import annotations

import copy
import json
import pickle
import random
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavjepa_tpu_torch.api.runtime import DeviceLike, resolve_device
from wavjepa_tpu_torch.eval.score import (
    ScoreFunction,
    available_scores,
    label_to_binary_vector,
    label_vocab_as_dict,
    read_label_vocab,
)

TASK_SPECIFIC_PARAM_GRID = {
    "dcase2016_task2": {"check_val_every_n_epoch": [10]},
}

PARAM_GRID = {
    "hidden_layers": [1, 2],
    "hidden_dim": [1024],
    "dropout": [0.1],
    "lr": [3.2e-3, 1e-3, 3.2e-4, 1e-4],
    "patience": [20],
    "max_epochs": [500],
    "check_val_every_n_epoch": [3],
    "batch_size": [1024],
    "initialization": ["xavier_uniform", "xavier_normal"],
}

FAST_PARAM_GRID = copy.deepcopy(PARAM_GRID)
FAST_PARAM_GRID.update({"max_epochs": [10, 50], "check_val_every_n_epoch": [3, 10]})

FASTER_PARAM_GRID = copy.deepcopy(PARAM_GRID)
FASTER_PARAM_GRID.update(
    {
        "hidden_layers": [0, 1],
        "hidden_dim": [64, 128],
        "patience": [1, 3],
        "max_epochs": [10],
        "check_val_every_n_epoch": [1],
    }
)

EVENT_POSTPROCESSING_GRID = {
    "median_filter_ms": [250],
    "min_duration": [125, 250],
}


def parameter_grid(grid: Dict[str, List]) -> List[Dict[str, Any]]:
    """sklearn ParameterGrid equivalent (sorted-key cartesian product)."""
    keys = sorted(grid.keys())
    confs: List[Dict[str, Any]] = [{}]
    for key in keys:
        confs = [dict(c, **{key: v}) for c in confs for v in grid[key]]
    return confs


# ------------------------------------------------------------------ probe model


class ProbeBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over (N, F): in training, normalised by the
    batch mean and biased variance (E[x²] − E[x]², clipped at 0), which
    also update the running averages (``momentum`` of the batch); in
    evaluation, normalised by the running averages."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(0)
            var = (x.square().mean(0) - mean.square()).clamp_min(0.0)
            with torch.no_grad():  # flax: decay · average + (1 − decay) · batch
                decay = 1.0 - self.momentum
                self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
                self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep with probability 1 − rate, scale by its
    inverse; the draw from ``generator``."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class FullyConnectedProbe(nn.Module):
    """The reference's FullyConnectedPrediction (task_predictions.py:142-194)
    as the JAX package builds it: ``hidden_layers`` × (Linear → BatchNorm →
    Dropout → ReLU), then a Linear to the labels."""

    def __init__(self, nfeatures: int, nlabels: int, prediction_type: str, conf: Dict):
        super().__init__()
        self.prediction_type = prediction_type
        self.conf = conf
        self.nfeatures, self.nlabels = nfeatures, nlabels
        dims = [nfeatures] + [conf["hidden_dim"]] * conf["hidden_layers"]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(ProbeBatchNorm(b) for b in dims[1:])
        self.out = nn.Linear(dims[-1], nlabels)
        self.rate = conf["dropout"]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """xavier (uniform or normal, ``conf["initialization"]``) at gain 1
        for the first layer and the ReLU's √2 after it; zero biases; unit
        norms."""
        init = {"xavier_uniform": nn.init.xavier_uniform_,
                "xavier_normal": nn.init.xavier_normal_}[self.conf["initialization"]]
        gain = 1.0
        for lin in [*self.hidden, self.out]:
            init(lin.weight, gain=gain, generator=generator)
            nn.init.zeros_(lin.bias)
            gain = float(np.sqrt(2.0))
        for norm in self.norms:
            norm.weight.fill_(1.0)
            norm.bias.zero_()
            norm.running_mean.zero_()
            norm.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for lin, norm in zip(self.hidden, self.norms):
            x = norm(lin(x))
            if self.training:
                x = dropout(x, self.rate, generator)
            x = torch.relu(x)
        return self.out(x)

    def loss(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "multilabel":
            return F.binary_cross_entropy_with_logits(logits, y)
        return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> np.ndarray:
        """Probabilities (sigmoid or softmax) in evaluation mode, on the host."""
        self.eval()
        logits = self(x)
        probs = torch.sigmoid(logits) if self.prediction_type == "multilabel" else \
            torch.softmax(logits, dim=-1)
        return probs.float().cpu().numpy()


def probe_state_dict_from_jax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """A flax probe's ``params`` and ``batch_stats`` (numpy trees) → the
    port's state_dict: ``Dense_{i}`` → ``hidden.{i}`` (the last → ``out``),
    kernel (in, out) → weight (out, in); ``BatchNorm_{i}`` → ``norms.{i}``
    (scale, bias, mean, var)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    dense = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(dense):
        prefix = "out" if i == len(dense) - 1 else f"hidden.{i}"
        out[f"{prefix}.weight"] = t(params[name]["kernel"]).T.contiguous()
        out[f"{prefix}.bias"] = t(params[name]["bias"])
    for name, p in params.items():
        if name.startswith("BatchNorm_"):
            i = int(name[10:])
            out[f"norms.{i}.weight"] = t(p["scale"])
            out[f"norms.{i}.bias"] = t(p["bias"])
            out[f"norms.{i}.running_mean"] = t(batch_stats[name]["mean"])
            out[f"norms.{i}.running_var"] = t(batch_stats[name]["var"])
    return out


# ------------------------------------------------------------------ datasets


class SplitData:
    """In-memory view of one or more consolidated splits
    (SplitMemmapDataset, task_predictions.py:539-618)."""

    def __init__(
        self,
        embedding_path: Path,
        split_names: Sequence[str],
        label_to_idx: Dict[str, int],
        nlabels: int,
        embedding_type: str,
    ):
        xs, ys, fnames, ts = [], [], [], []
        for split in split_names:
            dims = json.loads(
                (embedding_path / f"{split}.embedding-dimensions.json").read_text()
            )
            x = np.memmap(
                embedding_path / f"{split}.embeddings.npy",
                dtype=np.float32,
                mode="r",
                shape=tuple(dims),
            )
            with open(embedding_path / f"{split}.target-labels.pkl", "rb") as fp:
                labels = pickle.load(fp)
            y = np.stack(
                [
                    label_to_binary_vector(
                        [label_to_idx[str(lbl)] for lbl in row], nlabels
                    )
                    for row in labels
                ]
            )
            xs.append(np.asarray(x))
            ys.append(y)
            if embedding_type == "event":
                ft = json.loads(
                    (embedding_path / f"{split}.filename-timestamps.json").read_text()
                )
                fnames += [f for f, _ in ft]
                ts += [t for _, t in ft]
        self.x = np.concatenate(xs) if xs else np.zeros((0, 0), np.float32)
        self.y = np.concatenate(ys) if ys else np.zeros((0, 0), np.float32)
        self.filenames = fnames
        self.timestamps = np.asarray(ts, np.float64)

    def __len__(self):
        return len(self.x)


# ------------------------------------------------------------------ events


def median_filter_1d(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along axis 0 — the exact scipy call the reference
    protocol makes (task_predictions.py:39,506: median_filter(size=(w, 1)),
    default 'reflect' boundary), so event postprocessing scores stay
    comparable. scipy is a hard dependency of the event-task path."""
    from scipy.ndimage import median_filter

    return median_filter(x, size=(width, 1))


def create_events_from_prediction(
    prediction_dict: Dict[float, np.ndarray],
    idx_to_label: Dict[int, str],
    threshold: float = 0.5,
    median_filter_ms: float = 150,
    min_duration: float = 60.0,
) -> List[Dict[str, Any]]:
    """Frame probabilities → event list: threshold, median filter, merge
    adjacent frames, drop events shorter than min_duration ms
    (task_predictions.py:621-689)."""
    timestamps = np.array(sorted(prediction_dict.keys()))
    predictions = np.stack([prediction_dict[t] for t in timestamps])
    ts_diff = np.mean(np.diff(timestamps)) if len(timestamps) > 1 else 1.0
    if median_filter_ms:
        width = int(round(median_filter_ms / ts_diff))
        if width:
            predictions = median_filter_1d(predictions, width)
    binary = predictions > threshold
    events = []
    for label in range(binary.shape[1]):
        active = np.where(binary[:, label])[0]
        if active.size == 0:
            continue
        # split into consecutive runs
        splits = np.where(np.diff(active) > 1)[0] + 1
        for run in np.split(active, splits):
            start, end = timestamps[run[0]], timestamps[run[-1]]
            if end - start >= min_duration:
                events.append(
                    {"label": idx_to_label[label], "start": float(start), "end": float(end)}
                )
    events.sort(key=lambda e: e["start"])
    return events


def get_events_for_all_files(
    predictions: np.ndarray,
    filenames: List[str],
    timestamps: np.ndarray,
    idx_to_label: Dict[int, str],
    postprocessing_grid: Dict[str, List[float]],
    postprocessing: Optional[Tuple[Tuple[str, Any], ...]] = None,
) -> Dict[Tuple[Tuple[str, Any], ...], Dict[str, List[Dict[str, Any]]]]:
    """Group frame predictions by file, then eventize under one or every
    postprocessing configuration (task_predictions.py:692-770)."""
    event_files: Dict[str, Dict[float, np.ndarray]] = {}
    for i, (filename, timestamp) in enumerate(zip(filenames, timestamps)):
        slug = Path(filename).name
        event_files.setdefault(slug, {})[float(timestamp)] = predictions[i]

    confs = (
        [dict(postprocessing)]
        if postprocessing
        else parameter_grid(postprocessing_grid)
    )
    event_dict: Dict[Tuple[Tuple[str, Any], ...], Dict[str, List[Dict[str, Any]]]] = {}
    for conf in confs:
        key = tuple(sorted(conf.items()))
        event_dict[key] = {
            slug: create_events_from_prediction(preds, idx_to_label, **conf)
            for slug, preds in event_files.items()
        }
    return event_dict


# ------------------------------------------------------------------ training


class GridPointResult:
    """One trained configuration: its best validation score and the probe's
    state_dict (on the host) at that epoch."""

    def __init__(self, conf, validation_score, score_mode, state_dict, epoch,
                 postprocessing, time_in_min):
        self.conf = conf
        self.validation_score = validation_score
        self.score_mode = score_mode
        self.state_dict = state_dict
        self.epoch = epoch
        self.postprocessing = postprocessing
        self.time_in_min = time_in_min

    def __repr__(self):
        return (
            f"GridPointResult(val={self.validation_score:.4f}, "
            f"epoch={self.epoch}, conf={self.conf})"
        )


def _combine_target_events(embedding_path: Path, split_names: List[str]) -> Dict:
    combined: Dict = {}
    for split in split_names:
        combined.update(json.loads((embedding_path / f"{split}.json").read_text()))
    return combined


def _primary_score_value(ret) -> float:
    if isinstance(ret, tuple):
        value = ret[0][1]
    else:
        value = ret
    return 0.0 if np.isnan(value) else float(value)


def _scores_to_dict(name: str, scores: List[ScoreFunction], args) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for score_fn in scores:
        ret = score_fn(*args)
        if isinstance(ret, tuple):
            for sub_name, value in ret:
                out[f"{name}_{score_fn}_{sub_name}"] = value
            out[f"{name}_score"] = ret[0][1]
        else:
            out[f"{name}_{score_fn}"] = float(ret)
    return out


def task_predictions_train(
    embedding_path: Path,
    embedding_size: int,
    metadata: Dict,
    data_splits: Dict[str, List[str]],
    label_to_idx: Dict[str, int],
    nlabels: int,
    scores: List[ScoreFunction],
    conf: Dict,
    use_scoring_for_early_stopping: bool = True,
    seed: int = 42,
    device: DeviceLike = None,
) -> GridPointResult:
    """Train one probe configuration with early stopping on the primary
    score; returns the best epoch's weights (task_predictions.py:903-1078)."""
    dev = resolve_device(device)
    start_time = time.time()
    embedding_type = metadata["embedding_type"]
    idx_to_label = {v: k for k, v in label_to_idx.items()}

    train = SplitData(embedding_path, data_splits["train"], label_to_idx, nlabels, embedding_type)
    valid = SplitData(embedding_path, data_splits["valid"], label_to_idx, nlabels, embedding_type)

    is_event = embedding_type == "event"
    if is_event:
        validation_target_events = _combine_target_events(
            embedding_path, data_splits["valid"]
        )
        postprocessing_grid = metadata.get("evaluation_params", {}).get(
            "event_postprocessing_grid", EVENT_POSTPROCESSING_GRID
        )
    else:
        validation_target_events, postprocessing_grid = None, None

    probe = FullyConnectedProbe(embedding_size, nlabels, metadata["prediction_type"], conf)
    probe.reset_parameters(torch.Generator().manual_seed(seed))
    probe.to(dev)
    optimizer = torch.optim.Adam(probe.parameters(), lr=conf["lr"])
    dropout_rng = torch.Generator(device=dev).manual_seed(seed)
    train_x, train_y = torch.from_numpy(train.x).to(dev), torch.from_numpy(train.y).to(dev)
    valid_x = torch.from_numpy(valid.x).to(dev)

    mode = "max" if scores[0].maximize else "min"
    sign = 1.0 if mode == "max" else -1.0
    best = -np.inf
    best_state, best_epoch, best_post = _host_state(probe), 0, None
    patience_left = conf["patience"]
    rng = np.random.default_rng(seed)

    def evaluate_valid():
        """→ (primary_score, best_postprocessing) on the validation split."""
        probs = probe.predict(valid_x)
        if is_event:
            events_by_post = get_events_for_all_files(
                probs, valid.filenames, valid.timestamps, idx_to_label,
                postprocessing_grid,
            )
            scored = []
            for post, events in events_by_post.items():
                value = _primary_score_value(scores[0](events, validation_target_events))
                scored.append((value, post))
            scored.sort(key=lambda t: sign * t[0], reverse=True)
            return scored[0][0], scored[0][1]
        return _primary_score_value(scores[0](probs, valid.y)), None

    bs = conf["batch_size"]
    n = len(train)
    for epoch in range(1, conf["max_epochs"] + 1):
        probe.train()
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for i in range(0, n, bs):
            idx = perm[i : i + bs]
            loss = probe.loss(probe(train_x[idx], dropout_rng), train_y[idx])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        if epoch % conf["check_val_every_n_epoch"] != 0:
            continue
        val_score, val_post = evaluate_valid()
        if best == -np.inf or sign * val_score > sign * best:
            best = val_score
            best_state, best_epoch, best_post = _host_state(probe), epoch, val_post
            patience_left = conf["patience"]
        else:
            patience_left -= 1
            if patience_left <= 0:
                break

    return GridPointResult(
        conf=conf,
        validation_score=float(best),
        score_mode=mode,
        state_dict=best_state,
        epoch=best_epoch,
        postprocessing=best_post,
        time_in_min=(time.time() - start_time) / 60,
    )


def _host_state(probe: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in probe.state_dict().items()}


def task_predictions_test(
    embedding_path: Path,
    grid_point: GridPointResult,
    metadata: Dict,
    data_splits: Dict[str, List[str]],
    label_to_idx: Dict[str, int],
    nlabels: int,
    scores: List[ScoreFunction],
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Evaluate the best epoch's weights on the test split
    (task_predictions.py:1081-1114)."""
    dev = resolve_device(device)
    embedding_type = metadata["embedding_type"]
    idx_to_label = {v: k for k, v in label_to_idx.items()}
    test = SplitData(
        embedding_path, data_splits["test"], label_to_idx, nlabels, embedding_type
    )
    probe = FullyConnectedProbe(
        test.x.shape[1], nlabels, metadata["prediction_type"], grid_point.conf
    )
    probe.load_state_dict(grid_point.state_dict)
    probs = probe.to(dev).predict(torch.from_numpy(test.x).to(dev))

    if embedding_type == "event":
        target_events = _combine_target_events(embedding_path, data_splits["test"])
        postprocessing_grid = metadata.get("evaluation_params", {}).get(
            "event_postprocessing_grid", EVENT_POSTPROCESSING_GRID
        )
        post = grid_point.postprocessing or tuple(
            sorted(parameter_grid(postprocessing_grid)[0].items())
        )
        events = get_events_for_all_files(
            probs, test.filenames, test.timestamps, idx_to_label,
            postprocessing_grid, post,
        )[tuple(sorted(dict(post).items()))]
        return _scores_to_dict("test", scores, (events, target_events))
    return _scores_to_dict("test", scores, (probs, test.y))


# ------------------------------------------------------------------ the protocol


def data_splits_from_folds(folds: List[str]) -> List[Dict[str, List[str]]]:
    """LOOCV split construction (task_predictions.py:1128-1163)."""
    sorted_folds = tuple(sorted(folds))
    assert len(sorted_folds) == len(set(sorted_folds))
    num = len(sorted_folds)
    splits = []
    for i in range(num):
        test_fold = sorted_folds[i]
        valid_fold = sorted_folds[(i + 1) % num]
        train_folds = [f for f in sorted_folds if f not in (test_fold, valid_fold)]
        splits.append({"train": train_folds, "valid": [valid_fold], "test": [test_fold]})
    return splits


def get_splits_from_metadata(metadata: Dict) -> List[Dict[str, List[str]]]:
    if metadata["split_mode"] == "trainvaltest":
        return [{"train": ["train"], "valid": ["valid"], "test": ["test"]}]
    if metadata["split_mode"] in ("new_split_kfold", "presplit_kfold"):
        return data_splits_from_folds(metadata["splits"])
    raise AssertionError(f"Unknown split_mode: {metadata['split_mode']}")


def aggregate_test_results(results: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    keys = set()
    for fold in results.values():
        keys |= set(k for k, v in fold.items() if isinstance(v, (int, float)))
    agg = {}
    for key in sorted(keys):
        vals = [fold[key] for fold in results.values() if key in fold]
        agg[f"{key}_mean"] = float(np.mean(vals))
        agg[f"{key}_std"] = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
    return agg


def task_predictions(
    embedding_path: Path,
    embedding_size: Optional[int] = None,
    grid_points: int = 8,
    grid: str = "default",
    seed: int = 42,
    device: DeviceLike = None,
) -> Dict:
    """Full per-task prediction protocol (task_predictions.py:1279-1453):
    random grid search on the first split, best conf retrained on remaining
    folds, per-fold test, aggregation, test.predicted-scores.json."""
    device = resolve_device(device)
    embedding_path = Path(embedding_path)
    metadata = json.loads((embedding_path / "task_metadata.json").read_text())
    label_vocab = read_label_vocab(embedding_path / "labelvocabulary.csv")
    nlabels = len(label_vocab)
    label_to_idx = label_vocab_as_dict(label_vocab, key="label", value="idx")
    scores = [
        available_scores[score](label_to_idx=label_to_idx)
        for score in metadata["evaluation"]
    ]
    data_splits = get_splits_from_metadata(metadata)

    if embedding_size is None:
        dims = json.loads(
            (
                embedding_path
                / f"{data_splits[0]['train'][0]}.embedding-dimensions.json"
            ).read_text()
        )
        embedding_size = dims[1]

    final_grid = {
        "default": copy.copy(PARAM_GRID),
        "fast": copy.copy(FAST_PARAM_GRID),
        "faster": copy.copy(FASTER_PARAM_GRID),
    }[grid]
    if metadata["task_name"] in TASK_SPECIFIC_PARAM_GRID:
        final_grid.update(TASK_SPECIFIC_PARAM_GRID[metadata["task_name"]])
    if "task_specific_param_grid" in metadata.get("evaluation_params", {}):
        final_grid.update(metadata["evaluation_params"]["task_specific_param_grid"])

    confs = parameter_grid(final_grid)
    random.Random(seed).shuffle(confs)

    results: List[GridPointResult] = []
    for confi, conf in enumerate(confs[:grid_points]):
        print(f"grid point {confi + 1}/{grid_points}: {conf}", flush=True)
        results.append(
            task_predictions_train(
                embedding_path, embedding_size, metadata, data_splits[0],
                label_to_idx, nlabels, scores, conf, seed=seed, device=device,
            )
        )
    sign = 1.0 if results[0].score_mode == "max" else -1.0
    results.sort(key=lambda g: sign * g.validation_score, reverse=True)
    best = results[0]
    print(f"best grid point: {best}", flush=True)

    split_grid_points = [best]
    for split in data_splits[1:]:
        split_grid_points.append(
            task_predictions_train(
                embedding_path, embedding_size, metadata, split,
                label_to_idx, nlabels, scores, best.conf, seed=seed, device=device,
            )
        )

    test_results: Dict[str, Any] = {}
    for i, split in enumerate(data_splits):
        fold_str = "|".join(split["test"])
        fold_scores = task_predictions_test(
            embedding_path, split_grid_points[i], metadata, split,
            label_to_idx, nlabels, scores, device,
        )
        fold_scores.update(
            {
                "validation_score": split_grid_points[i].validation_score,
                "epoch": split_grid_points[i].epoch,
                "time_in_min": split_grid_points[i].time_in_min,
            }
        )
        test_results[fold_str] = fold_scores

    if len(test_results) > 1:
        test_results["aggregated_scores"] = aggregate_test_results(
            {k: v for k, v in test_results.items()}
        )
    test_results.update(
        {
            "hparams": {k: str(v) for k, v in best.conf.items()},
            "postprocessing": [list(kv) for kv in (best.postprocessing or [])],
            "score_mode": best.score_mode,
            "embedding_path": str(embedding_path),
        }
    )
    (embedding_path / "test.predicted-scores.json").write_text(
        json.dumps(test_results, indent=4)
    )
    return test_results


def runner(
    embedding_dirs: List[str],
    grid_points: int = 8,
    grid: str = "default",
    device: DeviceLike = None,
) -> Dict[str, Dict]:
    """Predictions CLI body (predictions/runner.py:51-177):
    prediction-done.json idempotency + per-task scoring, the probes on
    ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    all_results = {}
    for emb_dir in embedding_dirs:
        emb_dir = Path(emb_dir)
        done_file = emb_dir / "prediction-done.json"
        if done_file.exists():
            print(f"{emb_dir.name}: predictions already computed", flush=True)
            all_results[str(emb_dir)] = json.loads(
                (emb_dir / "test.predicted-scores.json").read_text()
            )
            continue
        start = time.time()
        result = task_predictions(emb_dir, grid_points=grid_points, grid=grid, device=device)
        done_file.write_text(json.dumps({"time_s": time.time() - start}))
        all_results[str(emb_dir)] = result
    return all_results
