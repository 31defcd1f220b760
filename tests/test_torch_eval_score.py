"""The port's HEAR score library against the JAX package's: every registered
score on seeded predictions, the sklearn-free mAP, ROC AUC and d′ against
the JAX package's (that is, scikit-learn's) where they are easiest to get
wrong, and the sed_eval conformance fixtures of tests/test_eval_harness.py
run on the port. Equal within 1e-12, or nan where the JAX package gives nan."""

import sys
import warnings

import numpy as np
import pandas as pd
import pytest

from wavjepa_tpu.eval import score as jscore
from wavjepa_tpu_torch.eval import score as tscore

CLASSIFIER_SCORES = ("top1_acc", "pitch_acc", "chroma_acc", "mAP", "d_prime", "aucroc")


def _same(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12


def _scores(name, *args, label_to_idx=None):
    with warnings.catch_warnings():  # sklearn warns at a class-free column
        warnings.simplefilter("ignore")
        out = [pkg.available_scores[name](label_to_idx=label_to_idx or {"a": 0, "b": 1})(*args)
               for pkg in (jscore, tscore)]
    return out


def _seeded_events(seed: int):
    rng = np.random.default_rng(seed)
    labels = ("a", "b")

    def events(n):
        starts = rng.uniform(0, 8000, n)
        return [{"label": str(rng.choice(labels)), "start": float(s),
                 "end": float(s + rng.uniform(50, 2000))} for s in starts]

    targets = {f"f{i}": events(4) for i in range(5)}
    # predictions near the targets (some within the collars), and spurious ones
    preds = {f: [{"label": e["label"], "start": e["start"] + rng.normal(0, 120),
                  "end": e["end"] + rng.normal(0, 300)} for e in evs] + events(1)
             for f, evs in targets.items()}
    return preds, targets


def test_both_registries_hold_the_same_scores():
    assert set(tscore.available_scores) == set(jscore.available_scores)


@pytest.mark.parametrize("name", sorted(jscore.available_scores))
def test_every_score_matches_the_jax_package(name):
    if name in CLASSIFIER_SCORES:
        rng = np.random.default_rng(7)
        targets = np.eye(12, dtype=np.float32)[rng.integers(0, 12, 64)]
        targets[::5, 3] = 1.0  # multi-hot rows
        logits = rng.standard_normal((64, 12)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        a, b = _scores(name, probs, targets)
        assert _same(a, b), (a, b)
        return
    preds, targets = _seeded_events(3)
    a, b = _scores(name, preds, targets)
    assert isinstance(b, tuple) and [k for k, _ in a] == [k for k, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert _same(x, y), (a, b)


def _ranking_case(kind: str):
    rng = np.random.default_rng({"ties": 1, "constant": 2, "positive_free": 3,
                                 "all_positive": 4, "single_class": 5, "one_column": 6,
                                 "random": 7}[kind])
    y = (rng.random((50, 6)) < 0.3).astype(np.float32)
    p = rng.random((50, 6)).astype(np.float32)
    if kind == "ties":
        p = np.round(p * 3) / 3  # four distinct scores a column
    elif kind == "constant":
        p = np.full_like(p, 0.25)
    elif kind == "positive_free":
        y[:, 2] = 0.0
    elif kind == "all_positive":
        y[:, 4] = 1.0
    elif kind == "single_class":  # every row the same one label
        y = np.zeros_like(y)
        y[:, 0] = 1.0
    elif kind == "one_column":
        p, y = p[:, :1], y[:, :1]
    return p, y


@pytest.mark.parametrize("kind", ["random", "ties", "constant", "positive_free",
                                  "all_positive", "single_class", "one_column"])
@pytest.mark.parametrize("name", ["mAP", "aucroc", "d_prime"])
def test_ranking_scores_match_sklearn_at_the_edges(name, kind):
    p, y = _ranking_case(kind)
    a, b = _scores(name, p, y)
    assert _same(a, b), (a, b)
    if kind in ("positive_free", "all_positive", "single_class") and name != "mAP":
        assert np.isnan(b)  # a one-class column has no AUC


def test_positive_free_column_has_zero_ap():
    y = np.array([0, 0, 0, 0], np.float32)
    assert tscore.binary_average_precision(y, np.array([0.9, 0.1, 0.5, 0.5])) == 0.0


def test_label_vocab_rows_match_the_dataframe(tmp_path):
    path = tmp_path / "labelvocabulary.csv"
    path.write_text("idx,label\n0,dog\n1,21\n2,cat bark\n")
    rows = tscore.read_label_vocab(path)
    ref = jscore.label_vocab_as_dict(pd.read_csv(path), key="label", value="idx")
    assert tscore.label_vocab_as_dict(rows, key="label", value="idx") == ref
    assert tscore.label_vocab_as_dict(rows, key="idx", value="label") == {
        0: "dog", 1: "21", 2: "cat bark"}


# ------------------------------------------- sed_eval conformance, on the port


def _port(name, **kw):
    return tscore.available_scores[name](label_to_idx=kw.get("labels", {"a": 0}))


def test_event_score_matching():
    score = _port("event_onset_200ms_fms")
    targets = {"f1": [{"label": "a", "start": 1000.0, "end": 2000.0}]}
    preds = {"f1": [{"label": "a", "start": 1100.0, "end": 2500.0}]}
    assert dict(score(preds, targets))["f_measure"] == pytest.approx(1.0)
    preds = {"f1": [{"label": "a", "start": 1300.0, "end": 2000.0}]}
    assert dict(score(preds, targets))["f_measure"] == pytest.approx(0.0)


def test_segment_error_rate():
    score = _port("segment_1s_er")
    targets = {"f1": [{"label": "a", "start": 0.0, "end": 2000.0}]}
    assert dict(score(targets, targets))["error_rate"] == pytest.approx(0.0)
    assert dict(score({"f1": []}, targets))["error_rate"] == pytest.approx(1.0)


def test_event_score_maximum_matching_beats_greedy():
    score = _port("event_onset_offset_50ms_20perc_fms")
    targets = {"f1": [{"label": "a", "start": 100.0, "end": 600.0},
                      {"label": "a", "start": 120.0, "end": 450.0}]}
    preds = {"f1": [{"label": "a", "start": 90.0, "end": 510.0},
                    {"label": "a", "start": 110.0, "end": 650.0}]}
    ret = dict(score(preds, targets))
    assert ret["f_measure"] == ret["precision"] == ret["recall"] == pytest.approx(1.0)


def test_event_score_iterates_prediction_files_only():
    score = _port("event_onset_200ms_fms")
    targets = {"f1": [{"label": "a", "start": 0.0, "end": 1000.0}],
               "f2": [{"label": "a", "start": 0.0, "end": 1000.0}]}
    preds = {"f1": [{"label": "a", "start": 50.0, "end": 1000.0}]}
    assert dict(score(preds, targets))["recall"] == pytest.approx(1.0)


def test_event_score_onset_collar_boundary():
    score = _port("event_onset_200ms_fms")
    targets = {"f1": [{"label": "a", "start": 1000.0, "end": 2000.0}]}
    preds = {"f1": [{"label": "a", "start": 1200.0, "end": 2000.0}]}
    assert dict(score(preds, targets))["f_measure"] == pytest.approx(1.0)


def test_segment_grid_extends_to_estimated_events():
    score = _port("segment_1s_er")
    targets = {"f1": [{"label": "a", "start": 0.0, "end": 1500.0}]}
    preds = {"f1": [{"label": "a", "start": 3200.0, "end": 4000.0}]}
    assert dict(score(preds, targets))["error_rate"] == pytest.approx(1.5)


def test_segment_substitution_counting():
    score = _port("segment_1s_er", labels={"a": 0, "b": 1})
    targets = {"f1": [{"label": "a", "start": 0.0, "end": 900.0}]}
    preds = {"f1": [{"label": "b", "start": 100.0, "end": 800.0}]}
    assert dict(score(preds, targets))["error_rate"] == pytest.approx(1.0)


def test_sed_scores_empty_inputs_are_zero_not_nan():
    ev, seg = _port("event_onset_200ms_fms"), _port("segment_1s_er")
    assert dict(ev({}, {}))["f_measure"] == 0.0
    assert dict(seg({}, {}))["error_rate"] == 0.0
    assert dict(ev({"f1": []}, {"f1": []}))["f_measure"] == 0.0


def test_event_matching_deep_augmenting_paths_no_recursion_limit():
    n = 600  # augmenting paths three times the recursion limit set below
    adj = [[i - 1, i] if i else [0] for i in range(n)]
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(200)
    try:
        assert tscore._max_matching(adj, n) == n
    finally:
        sys.setrecursionlimit(limit)
