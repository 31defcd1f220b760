"""Downstream-evaluation score library (HEAR 2021 contract).

The port's own copy of ``wavjepa_tpu/eval/score.py``: the same registry,
the same sed_eval event and segment metrics (numpy), and top-1 and chroma
accuracy. ``MeanAveragePrecision``, ``AUCROC`` and ``DPrime`` compute
scikit-learn's definitions without it:

  * a column's scores sorted in descending order (a stable sort, reversed),
    tied scores grouped into one threshold, the true and false positives
    summed at each distinct threshold;
  * AP is the step-wise sum Σ (R_n − R_{n−1}) P_n over those thresholds, not
    interpolated; a column with no positive has recall 1 at every threshold,
    so its AP is 0;
  * ROC AUC is the trapezoid over the distinct thresholds, after dropping
    the collinear points as ``roc_curve`` does; a column with one class has
    no AUC (``nan``);
  * the macro average is the mean over the label columns; ``nan`` where a
    column has none, as the JAX package returns it.

``label_vocab_as_dict`` takes the rows of ``labelvocabulary.csv`` as
``csv.DictReader`` gives them, not a DataFrame.

Event dict format (identical to the reference pipeline):
    {filename: [{"label": str, "start": ms, "end": ms}, ...], ...}
"""

from __future__ import annotations

import csv
from functools import partial
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple,
                    Union)

import numpy as np

Ret = Union[Tuple[Tuple[str, float], ...], float]


def label_vocab_as_dict(rows: Iterable[Mapping[str, str]], key: str, value: str) -> Dict:
    """Label-vocabulary rows (``idx``, ``label``) → {label: idx} or
    {idx: label}, ``idx`` an int and ``label`` a str."""
    if key == "label":
        return {str(row["label"]): int(row["idx"]) for row in rows}
    assert key == "idx", "key argument must be either 'label' or 'idx'"
    return {int(row["idx"]): str(row["label"]) for row in rows}


def read_label_vocab(path) -> List[Dict[str, str]]:
    """The rows of a ``labelvocabulary.csv``."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def label_to_binary_vector(label: List[int], num_labels: int) -> np.ndarray:
    """List of integer labels → multi-hot float vector (score.py:35-54)."""
    binary = np.zeros((num_labels,), np.float32)
    if label:
        binary[np.asarray(label, int)] = 1.0
    return binary


def validate_score_return_type(ret: Ret):
    if isinstance(ret, tuple):
        assert all(
            isinstance(s, tuple) and isinstance(s[0], str) and isinstance(s[1], float)
            for s in ret
        )
    elif not isinstance(ret, float):
        raise ValueError(f"unexpected score return type {type(ret)}")


class ScoreFunction:
    """Abstract score functor (reference score.py:91-135)."""

    name: str = ""

    def __init__(
        self,
        label_to_idx: Dict[str, int],
        name: Optional[str] = None,
        maximize: bool = True,
    ):
        self.label_to_idx = label_to_idx
        if name:
            self.name = name
        self.maximize = maximize

    def __call__(self, *args, **kwargs) -> Ret:
        ret = self._compute(*args, **kwargs)
        validate_score_return_type(ret)
        return ret

    def _compute(self, predictions: Any, targets: Any, **kwargs) -> Ret:
        raise NotImplementedError

    def __str__(self):
        return self.name


class Top1Accuracy(ScoreFunction):
    name = "top1_acc"

    def _compute(self, predictions: np.ndarray, targets: np.ndarray, **kwargs) -> float:
        assert predictions.ndim == 2 and targets.ndim == 2
        correct = np.argmax(predictions, 1) == np.argmax(targets, 1)
        return float(np.mean(correct))


class ChromaAccuracy(ScoreFunction):
    """Pitch accuracy ignoring octave errors (score.py:159-180)."""

    name = "chroma_acc"

    def _compute(self, predictions: np.ndarray, targets: np.ndarray, **kwargs) -> float:
        correct = (np.argmax(predictions, 1) % 12) == (np.argmax(targets, 1) % 12)
        return float(np.mean(correct))


def _curve_counts(y_true: np.ndarray, y_score: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """True and false positives at each distinct threshold, scores in
    descending order (scikit-learn's ``confusion_matrix_at_thresholds``)."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true.astype(np.float64))[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return tps, fps


def binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP of one label column: the step-wise sum over distinct thresholds
    (scikit-learn's uninterpolated ``average_precision_score``)."""
    tps, fps = _curve_counts(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate((precision[::-1], [1.0]))
    recall = np.concatenate((recall[::-1], [0.0]))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC AUC of one label column by the trapezoid over distinct
    thresholds; ``nan`` when the column holds one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    tps, fps = _curve_counts(y_true, y_score)
    if fps.shape[0] > 2:  # roc_curve's drop_intermediate
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        tps, fps = tps[keep], fps[keep]
    tpr = np.r_[0.0, tps] / tps[-1]
    fpr = np.r_[0.0, fps] / fps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def _per_column(metric: Callable, targets: np.ndarray, predictions: np.ndarray) -> np.ndarray:
    assert predictions.ndim == 2 and targets.ndim == 2
    return np.array([metric(targets[:, c], predictions[:, c])
                     for c in range(predictions.shape[1])], np.float64)


class MeanAveragePrecision(ScoreFunction):
    """Macro-averaged AP (score.py:292-318)."""

    name = "mAP"

    def _compute(self, predictions: np.ndarray, targets: np.ndarray, **kwargs) -> float:
        return float(np.mean(_per_column(binary_average_precision, targets, predictions)))


class DPrime(ScoreFunction):
    """ppf(auc)·√2, macro-averaged (score.py:321-345)."""

    name = "d_prime"

    def _compute(self, predictions: np.ndarray, targets: np.ndarray, **kwargs) -> float:
        from scipy import stats

        auc = _per_column(binary_roc_auc, targets, predictions)
        return float(np.mean(stats.norm().ppf(auc) * np.sqrt(2.0)))


class AUCROC(ScoreFunction):
    name = "aucroc"

    def _compute(self, predictions: np.ndarray, targets: np.ndarray, **kwargs) -> float:
        return float(np.mean(_per_column(binary_roc_auc, targets, predictions)))


# ----------------------------------------------------------- SED metrics
#
# sed_eval-exact re-implementations. The reference scores DCASE-style event
# tasks with sed_eval.sound_event.{EventBased,SegmentBased}Metrics
# (reference score.py:270-292,365-385): per file (iterating PREDICTION files
# only, score.py:225-229), events converted ms→seconds
# (sed_eval_event_container, score.py:244-261), then sed_eval's overall
# (micro) accumulation. Conventions reproduced exactly:
#   * denominators carry sed_eval.metric's eps = numpy.spacing(1) instead of
#     zero-guards (0/0 → 0.0);
#   * event matching is MAXIMUM bipartite matching on the (label, onset
#     collar, optional offset collar) hit graph — not greedy first-fit;
#   * onset condition |ref_on − est_on| ≤ t_collar; offset condition
#     |ref_off − est_off| ≤ max(t_collar, percentage_of_length · ref_len);
#   * segment grid per file: n_segments = ceil(max_offset_over_both_lists /
#     time_resolution); event roll onset = floor(on/res), offset =
#     ceil(off/res); per-segment joint counts Ntp/Nref/Nsys with
#     S = min(Nref,Nsys) − Ntp, D = max(0, Nref−Nsys), I = max(0, Nsys−Nref);
#   * overall ER = (ΣS + ΣD + ΣI) / (ΣNref + eps), F from ΣNtp/ΣNsys/ΣNref.
# Conformance fixtures (incl. a case where greedy ≠ maximum matching and
# file-duration grid edges) live in tests/test_eval_harness.py and
# tests/test_torch_eval_score.py.

EventDict = Dict[str, List[Dict[str, Any]]]

_EPS = float(np.spacing(1))  # sed_eval.metric eps convention


def _to_seconds(events: List[dict]) -> List[Tuple[str, float, float]]:
    """heareval event dicts (ms) → (label, onset_s, offset_s), the unit
    sed_eval receives (reference score.py:252-258)."""
    return [
        (str(e["label"]), e["start"] / 1000.0, e["end"] / 1000.0) for e in events
    ]


def _max_matching(adj: List[List[int]], n_right: int) -> int:
    """Maximum-cardinality bipartite matching (Kuhn's augmenting paths);
    cardinality equals sed_eval util.bipartite_match's Hopcroft–Karp.

    The augmenting-path DFS is iterative: a recursive walk recurses once per
    previously-matched vertex along the path, so a densely-annotated file
    with ~1000+ mutually-matchable same-label events would blow Python's
    default recursion limit mid-scoring."""
    match_right = [-1] * n_right

    def try_augment(root: int) -> bool:
        seen = [False] * n_right
        stack = [(root, iter(adj[root]))]
        via: List[int] = []  # via[d] = right vertex linking frame d to d+1
        while stack:
            u, it = stack[-1]
            step = None  # None → frame exhausted; -1 → descended; ≥0 → free v
            for v in it:
                if not seen[v]:
                    seen[v] = True
                    if match_right[v] == -1:
                        step = v
                    else:
                        stack.append((match_right[v], iter(adj[match_right[v]])))
                        via.append(v)
                        step = -1
                    break
            if step is None:
                stack.pop()
                if via:
                    via.pop()
            elif step >= 0:  # augment: flip matches along the DFS path
                match_right[step] = u
                for d in range(len(stack) - 2, -1, -1):
                    match_right[via[d]] = stack[d][0]
                return True
        return False

    matched = 0
    for u in range(len(adj)):
        if try_augment(u):
            matched += 1
    return matched


class EventBasedScore(ScoreFunction):
    """Event-instance F-measure with an onset collar (and optional offset
    condition) — sed_eval EventBasedMetrics overall scores, accumulated over
    prediction files (reference score.py:283-292 usage, sed_eval defaults
    percentage_of_length=0.5)."""

    def __init__(
        self,
        label_to_idx: Dict[str, int],
        scores: Tuple[str, ...] = ("f_measure", "precision", "recall"),
        params: Optional[Dict] = None,
        name: Optional[str] = None,
        maximize: bool = True,
    ):
        super().__init__(label_to_idx=label_to_idx, name=name, maximize=maximize)
        self.scores = scores
        params = params or {}
        self.t_collar = params.get("t_collar", 0.2)
        self.evaluate_onset = params.get("evaluate_onset", True)
        self.evaluate_offset = params.get("evaluate_offset", True)
        self.percentage_of_length = params.get("percentage_of_length", 0.5)

    def _hit(self, ref: Tuple[str, float, float], est: Tuple[str, float, float]) -> bool:
        if ref[0] != est[0]:
            return False
        if self.evaluate_onset and abs(ref[1] - est[1]) > self.t_collar:
            return False
        if self.evaluate_offset:
            tol = max(self.t_collar, self.percentage_of_length * (ref[2] - ref[1]))
            if abs(ref[2] - est[2]) > tol:
                return False
        return True

    def _compute(self, predictions: EventDict, targets: EventDict, **kwargs) -> Ret:
        ntp = nref = nsys = 0
        # heareval iterates over PREDICTION files only (score.py:225-229);
        # targets for files absent from predictions are never evaluated
        for filename in predictions:
            ests = _to_seconds(predictions.get(filename, []))
            refs = _to_seconds(targets.get(filename, []))
            nsys += len(ests)
            nref += len(refs)
            adj = [
                [j for j, est in enumerate(ests) if self._hit(ref, est)]
                for ref in refs
            ]
            ntp += _max_matching(adj, len(ests))
        precision = ntp / (nsys + _EPS)
        recall = ntp / (nref + _EPS)
        f = 2 * precision * recall / (precision + recall + _EPS)
        values = {"f_measure": f, "precision": precision, "recall": recall}
        return tuple((s, float(values[s])) for s in self.scores)


class SegmentBasedScore(ScoreFunction):
    """Fixed-grid segment activity metrics — sed_eval SegmentBasedMetrics
    overall error rate and F (reference score.py:270-280 usage)."""

    def __init__(
        self,
        label_to_idx: Dict[str, int],
        scores: Tuple[str, ...] = ("error_rate",),
        params: Optional[Dict] = None,
        name: Optional[str] = None,
        maximize: bool = False,
    ):
        super().__init__(label_to_idx=label_to_idx, name=name, maximize=maximize)
        self.scores = scores
        self.time_resolution = (params or {}).get("time_resolution", 1.0)

    def _event_roll(
        self, events: List[Tuple[str, float, float]], n_seg: int
    ) -> np.ndarray:
        """sed_eval util.event_list_to_event_roll: onset = floor(on/res),
        offset = ceil(off/res); unknown labels raise like list.index."""
        act = np.zeros((n_seg, len(self.label_to_idx)), bool)
        for label, on, off in events:
            if label not in self.label_to_idx:
                raise ValueError(f"event label {label!r} not in label vocabulary")
            li = self.label_to_idx[label]
            lo = int(np.floor(on / self.time_resolution))
            hi = int(np.ceil(off / self.time_resolution))
            act[max(lo, 0) : min(hi, n_seg), li] = True
        return act

    def _compute(self, predictions: EventDict, targets: EventDict, **kwargs) -> Ret:
        tot_s = tot_d = tot_i = tot_ref = tot_tp = tot_sys = 0.0
        for filename in predictions:
            ests = _to_seconds(predictions.get(filename, []))
            refs = _to_seconds(targets.get(filename, []))
            # sed_eval: evaluated length = max offset over BOTH lists,
            # segments = ceil(length / resolution)
            max_off = max([off for _, _, off in ests + refs] + [0.0])
            n_seg = int(np.ceil(max_off / self.time_resolution))
            if n_seg == 0:
                continue
            est_act = self._event_roll(ests, n_seg)
            ref_act = self._event_roll(refs, n_seg)
            ntp = (est_act & ref_act).sum(1).astype(float)
            nref = ref_act.sum(1).astype(float)
            nsys = est_act.sum(1).astype(float)
            s = np.minimum(nref, nsys) - ntp
            tot_s += s.sum()
            tot_d += np.maximum(0.0, nref - nsys).sum()
            tot_i += np.maximum(0.0, nsys - nref).sum()
            tot_ref += nref.sum()
            tot_sys += nsys.sum()
            tot_tp += ntp.sum()
        er = (tot_s + tot_d + tot_i) / (tot_ref + _EPS)
        precision = tot_tp / (tot_sys + _EPS)
        recall = tot_tp / (tot_ref + _EPS)
        f = 2 * precision * recall / (precision + recall + _EPS)
        values = {
            "error_rate": er,
            "f_measure": f,
            "precision": precision,
            "recall": recall,
        }
        return tuple((s, float(values[s])) for s in self.scores)


available_scores: Dict[str, Callable] = {
    "top1_acc": Top1Accuracy,
    "pitch_acc": partial(Top1Accuracy, name="pitch_acc"),
    "chroma_acc": ChromaAccuracy,
    "event_onset_200ms_fms": partial(
        EventBasedScore,
        name="event_onset_200ms_fms",
        scores=("f_measure", "precision", "recall"),
        params={"evaluate_onset": True, "evaluate_offset": False, "t_collar": 0.2},
    ),
    "event_onset_50ms_fms": partial(
        EventBasedScore,
        name="event_onset_50ms_fms",
        scores=("f_measure", "precision", "recall"),
        params={"evaluate_onset": True, "evaluate_offset": False, "t_collar": 0.05},
    ),
    "event_onset_offset_50ms_20perc_fms": partial(
        EventBasedScore,
        name="event_onset_offset_50ms_20perc_fms",
        scores=("f_measure", "precision", "recall"),
        params={
            "evaluate_onset": True,
            "evaluate_offset": True,
            "t_collar": 0.05,
            "percentage_of_length": 0.2,
        },
    ),
    "segment_1s_er": partial(
        SegmentBasedScore,
        name="segment_1s_er",
        scores=("error_rate",),
        params={"time_resolution": 1.0},
        maximize=False,
    ),
    "mAP": MeanAveragePrecision,
    "d_prime": DPrime,
    "aucroc": AUCROC,
}
