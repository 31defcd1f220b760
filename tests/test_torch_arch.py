"""The port's ARCH evaluation (``wavjepa_tpu_torch/eval/arch``) against the
JAX package's (``wavjepa_tpu/eval/arch``), on the CPU: the 12 recipes'
parsing on tiny layouts in the datasets' own formats, equal; the
train/validation split, equal to scikit-learn's; the metrics, equal to
scikit-learn's within 1e-12; the probes from flax's initial weights,
forward within 1e-5 and after 5 epochs of the same batches weights within
1e-4 and best-validation metrics within 1e-5; two recipes end to end with
a fake model, fold-mean metrics within 1e-4; WavJEPA embeddings from the
same JEPA weights within the runtime's f32 tolerance (atol 5e-5, rtol
1e-4); the embedding cache; and the download registry's dry run."""

import dataclasses
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import accuracy_score, average_precision_score, f1_score
from sklearn.model_selection import train_test_split

import wavjepa_tpu.eval.arch as jarch
from tests.test_arch import SR, FakeArchModel, _make_esc50_layout, _make_ravdess_layout
from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.eval.arch import probes as jprobes
from wavjepa_tpu.eval.arch import recipes as jrecipes
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
import wavjepa_tpu_torch.eval.arch as tarch
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.eval.arch import probes as tprobes
from wavjepa_tpu_torch.eval.arch import recipes as trecipes
from wavjepa_tpu_torch.models.jepa import JEPAConfig

ATOL, RTOL = 5e-5, 1e-4  # tests/test_torch_runtime.py's whole-model f32 tolerance


def canon(x):
    """numpy scalars and arrays → Python values and lists, recursively."""
    if isinstance(x, dict):
        return {canon(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


# ------------------------------------------------------------------ layouts


def _touch(path: Path, text: str = ""):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def layout_esc50(root):
    rows = ["filename,fold,target,category,esc10,src_file,take"]
    for i in range(30):
        fold, target = 1 + i % 3, (7 * i) % 5
        rows.append(f"{fold}-{1000 + i}-A-{target}.wav,{fold},{target},cat{target},False,{1000 + i},A")
    _touch(root / "meta" / "esc50.csv", "\n".join(rows) + "\n")
    return jarch.ESC50, tarch.ESC50, (str(root),)


def layout_us8k(root):
    rows = ["slice_file_name,fsID,start,end,salience,fold,classID,class"]
    for i in range(40):
        fold, cls = 1 + (3 * i) % 10, i % 4
        rows.append(f"{100 + i}-{cls}-0-{i}.wav,{100 + i},0.0,4.0,1,{fold},{cls},c{cls}")
    _touch(root / "metadata" / "UrbanSound8K.csv", "\n".join(rows) + "\n")
    return jarch.US8K, tarch.US8K, (str(root),)


def layout_vivae(root):
    for spk in ("01", "02", "11"):
        for emo in ("achievement", "anger", "fear", "pleasure"):
            for k in range(2):
                _touch(root / "full_set" / f"S{spk}_{emo}_low_{k:02d}.wav")
    return jarch.VIVAE, tarch.VIVAE, (str(root),)


def layout_fsd50k(root):
    gt = root / "FSD50K.ground_truth"
    labels = ["Bark", "Dog", "Speech", "Music", "Rain"]
    dev, ev = ["fname,labels,mids,split"], ["fname,labels,mids"]
    for i in range(24):
        lab = ",".join(labels[j] for j in sorted({i % 5, (i * 3) % 5}))
        dev.append(f'{64760 + i},"{lab}","/m/x",{"val" if i % 4 == 0 else "train"}')
    for i in range(8):
        ev.append(f'{37199 + i},"{labels[i % 5]}","/m/y"')
    _touch(gt / "dev.csv", "\n".join(dev) + "\n")
    _touch(gt / "eval.csv", "\n".join(ev) + "\n")
    return jarch.FSD50K, tarch.FSD50K, (str(root),)


def layout_fma(root):
    """tracks.csv as FMA ships it: two header rows, then the index's name
    on a row of its own; track ids of 1 to 6 digits."""
    meta = root / "fma_metadata"
    rows = [",album,set,set,track,track", ",title,split,subset,genre_top,title",
            "track_id,,,,,"]
    genres = ["Hip-Hop", "Pop", "Rock", "Folk"]
    tids = [2, 3, 5, 10, 20, 134, 999, 1000, 5555, 12345, 99999, 100000, 124911, 155066]
    for k, tid in enumerate(tids * 2):
        tid = tid + (k // len(tids)) * 7
        subset = "small" if k % 5 != 3 else "medium"
        rows.append(f"{tid},Album {k},training,{subset},{genres[k % 4]},\"Song, {k}\"")
    _touch(meta / "tracks.csv", "\n".join(rows) + "\n")
    # a transcoded sibling for one track, which resolve_audio_path prefers
    _touch(root / "fma_small" / "002" / "000002.wav")
    return (jarch.FMASmall, tarch.FMASmall,
            dict(config_path=str(meta), audio_files_path=str(root / "fma_small")))


def layout_mtt(root):
    """60 tags whose counts tie across the 50th place: pandas' unstable
    descending sort decides which of the tied tags enter the top 50."""
    rng = np.random.default_rng(0)
    tags = [f"tag{j:02d}" for j in range(60)]
    counts = [40 - j // 3 if j < 40 else 26 for j in range(60)]  # 20 tags tie at 26
    n = 48
    onehot = np.zeros((n, 60), np.int64)
    for j, c in enumerate(counts):
        onehot[rng.permutation(n)[:c], j] = 1
    header = "\t".join(f'"{c}"' for c in ["clip_id", *tags, "mp3_path"])
    lines = [header]
    for i in range(n):
        lines.append("\t".join([f'"{2 + 3 * i}"', *(f'"{v}"' for v in onehot[i]),
                                f'"{i % 16:x}/clip-{i}.mp3"']))
    _touch(root / "annotations_final.csv", "\n".join(lines) + "\n")
    for name, ids in (("train", range(0, 30)), ("val", range(30, 38)), ("test", range(38, 48))):
        rows = [f"{2 + 3 * i}\t{i % 16:x}/clip-{i}.mp3" for i in ids] + ["7777\tmissing.mp3"]
        _touch(root / f"{name}_gt_mtt.tsv", "\n".join(rows) + "\n")
    _touch(root / "3" / "clip-3.wav")
    return jarch.MagnaTagATune, tarch.MagnaTagATune, (str(root),)


def layout_irmas(root):
    inst = ["cel", "flu", "gac", "pia"]
    for i, ins in enumerate(inst):
        for k in range(5):
            _touch(root / "IRMAS-TrainingData" / ins / f"[{ins}][x]{k:04d}__1.wav")
    for p, part in enumerate(("Part1", "Part2", "Part3")):
        for k in range(3):
            base = root / f"IRMAS-TestingData-{part}" / part / f"song-{p}{k}"
            _touch(base.with_suffix(".wav"))
            _touch(base.with_suffix(".txt"), f"{inst[k % 4]}\t\n{inst[(k + p) % 4]}\nvoi\n")
    return jarch.IRMAS, tarch.IRMAS, (str(root),)


def layout_medleydb(root):
    rows = ["subset,instrument,instrument_id,song_id,uuid4"]
    subsets = ["training", "validation", "test"]
    for i in range(21):
        uid = f"{i:08x}-1c6a-51ab-fdb7-f8abd5fbf1a3"
        sub = subsets[i % 3]
        rows.append(f"{sub},inst{i % 4},{i % 4},{i // 2},{uid}")
        if i != 5:  # one row without audio
            _touch(root / "audio" / f"Medley-solos-DB_{sub}-{i % 4}_{uid}.wav")
    _touch(root / "Medley-solos-DB_metadata.csv", "\n".join(rows) + "\n")
    return jarch.MedleyDB, tarch.MedleyDB, (str(root),)


def layout_ravdess(root):
    for k in range(24):
        emo = 1 + k % 8
        _touch(root / f"Actor_{k % 6 + 1:02d}" / f"03-01-{emo:02d}-01-01-{k % 2 + 1:02d}-{k % 6 + 1:02d}.wav")
    return jarch.RAVDESS, tarch.RAVDESS, (str(root),)


def layout_audio_mnist(root):
    for spk in (1, 12, 13, 30, 45, 60):
        for digit in range(10):
            _touch(root / "data" / f"{spk:02d}" / f"{digit}_{spk:02d}_{spk % 3}.wav")
    return jarch.AudioMNIST, tarch.AudioMNIST, (str(root),)


def layout_slurp(root):
    for name, n in (("train", 6), ("devel", 3), ("test", 3)):
        lines = []
        for i in range(n):
            rec = [{"file": f"audio-{name}-{i}-{j}.flac"} for j in range(i % 3)]
            lines.append(json.dumps({"scenario": ["alarm", "music", "iot"][i % 3],
                                     "action": ["set", "query"][i % 2], "recordings": rec}))
        _touch(root / f"{name}.jsonl", "\n".join(lines) + "\n")
    return jarch.SLURP, tarch.SLURP, (str(root),)


def layout_emovo(root):
    for spk in ("f1", "m2", "m3"):
        for lab in ("dis", "gio", "neu", "pau"):
            for k in range(2):
                _touch(root / "EMOVO" / spk / f"{lab}-{spk}-b{k}.wav")
    return jarch.EMOVO, tarch.EMOVO, (str(root),)


LAYOUTS = [layout_esc50, layout_us8k, layout_vivae, layout_fsd50k, layout_fma, layout_mtt,
           layout_irmas, layout_medleydb, layout_ravdess, layout_audio_mnist, layout_slurp,
           layout_emovo]
RECIPE_FIELDS = ("num_classes", "label_map", "emotion_map", "label_names", "all_labels")


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f.__name__[7:] for f in LAYOUTS])
def test_recipe_parsing_equals_the_jax_package(tmp_path, layout):
    jcls, tcls, args = layout(tmp_path)
    kwargs = args if isinstance(args, dict) else {}
    args = () if isinstance(args, dict) else args
    ref, out = jcls(*args, **kwargs), tcls(*args, **kwargs)
    for field in RECIPE_FIELDS:
        assert canon(getattr(out, field, None)) == canon(getattr(ref, field, None)), field
    if hasattr(ref, "folds"):
        assert canon(out.folds) == canon(ref.folds)
        assert sum(len(f["audio_paths"]) for f in out.folds.values()) > 0
    else:
        assert set(out.splits) == set(ref.splits) == {"train", "valid", "test"}
        for name, (paths, labels) in ref.splits.items():
            assert out.splits[name][0] == paths, name
            assert type(out.splits[name][1]) is type(labels), name
            assert canon(out.splits[name][1]) == canon(labels), name
            assert len(paths) > 0, name
    assert out._all_audio_paths() == ref._all_audio_paths()


def test_mtt_top_tags_follow_the_unstable_sort(tmp_path):
    """The tie at the 50th place is decided as pandas decides it, which is
    not the stable order of the tag columns."""
    layout_mtt(tmp_path)
    out = tarch.MagnaTagATune(str(tmp_path))
    assert out.num_classes == 50
    assert out.label_names == jarch.MagnaTagATune(str(tmp_path)).label_names
    names, df = trecipes._read_table(str(tmp_path / "annotations_final.csv"), sep="\t")
    counts = {t: sum(df[t]) for t in names[1:-1]}
    assert sorted(counts[t] for t in out.label_names[40:]) == [26] * 10  # 10 of the 20 tied
    assert {t for t in counts if counts[t] > 26} == set(out.label_names[:40])


@pytest.mark.parametrize("test_size", [0.2, 0.5])
def test_train_val_split_equals_scikit_learn(test_size):
    for n in range(1, 61):
        paths = [f"clip{i}.wav" for i in range(n)]
        labels = list(np.arange(n) % 7)
        try:
            want = train_test_split(paths, labels, test_size=test_size, random_state=42)
        except ValueError:
            with pytest.raises(ValueError, match="train set will be empty"):
                trecipes._train_val_split(paths, labels, test_size=test_size)
            continue
        got = trecipes._train_val_split(paths, labels, test_size=test_size)
        assert got == want, n
        assert all(isinstance(g, list) for g in got)
        assert jrecipes._train_val_split(paths, labels, test_size=test_size) == want


def test_train_val_split_of_label_vectors_as_scikit_learn():
    ys = [np.eye(4, dtype=np.float32)[i % 4] for i in range(17)]
    got = trecipes._train_val_split([f"{i}" for i in range(17)], ys)
    want = train_test_split([f"{i}" for i in range(17)], ys, test_size=0.2, random_state=42)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_scikit_learn(seed):
    rng = np.random.default_rng(seed)
    n, c = 60, 6
    y = rng.integers(0, c - 1, n)  # class c - 1 never true
    pred = np.where(rng.random(n) < 0.6, y, rng.integers(0, c, n))
    pred[pred == 2] = 3  # class 2 never predicted
    assert tprobes.accuracy(y, pred) == pytest.approx(accuracy_score(y, pred), abs=1e-12)
    assert tprobes.macro_f1(y, pred) == pytest.approx(
        f1_score(y, pred, average="macro"), abs=1e-12)
    targets = (rng.random((n, c)) < 0.3).astype(np.float32)
    targets[:, 1] = 0.0  # a column with no positive: AP 0
    scores = np.round(rng.random((n, c)), 1).astype(np.float32)  # many tied scores
    for average in ("macro", "weighted"):
        assert tprobes.average_precision(targets, scores, average) == pytest.approx(
            average_precision_score(targets, scores, average=average), abs=1e-12)
    empty = np.zeros_like(targets)
    assert tprobes.average_precision(empty, scores, "weighted") == average_precision_score(
        empty, scores, average="weighted") == 0


# ------------------------------------------------------------------- probes


def _classification_data(seed, n=56, t=6, e=8, c=3, tokens=False, multilabel=False):
    rng = np.random.default_rng(seed)
    if multilabel:
        y = (rng.random((n, c)) > 0.5).astype(np.float32)
        x = y @ rng.standard_normal((c, e)) + 0.5 * rng.standard_normal((n, e))
        return x.astype(np.float32), y
    y = rng.integers(0, c, n)
    x = 0.5 * rng.standard_normal((n, t, e) if tokens else (n, e))
    x[np.arange(n), ..., y] += 1.0
    return x.astype(np.float32), y


PROBES = {
    "linear": dict(cls="ClassificationProbe", kw=dict(mode="linear")),
    "non_linear": dict(cls="ClassificationProbe", kw=dict(mode="non-linear", layers=[12])),
    "attention_pooling": dict(cls="ClassificationProbe", kw=dict(mode="attention-pooling"),
                              tokens=True),
    "multilabel": dict(cls="ClassificationProbe", kw=dict(mode="linear", is_multilabel=True),
                       multilabel=True),
    "sequence_bilstm": dict(cls="SequenceProbe", kw=dict(use_lstm=True, lstm_dim=6),
                            tokens=True, sequence=True),
}


def _probe_pair(name, seed=3):
    spec = PROBES[name]
    kw = dict(spec["kw"], input_embedding_size=8, num_classes=3, dropout=0.0, seed=seed)
    ref = getattr(jprobes, spec["cls"])(**kw)
    out = getattr(tprobes, spec["cls"])(**kw, device="cpu")
    x, y = _classification_data(seed, tokens=spec.get("tokens", False),
                                multilabel=spec.get("multilabel", False))
    if spec.get("sequence"):
        y = np.argmax(x, -1) % 3  # a label a token
    return ref, out, x, y


def _carry_flax_init(monkeypatch, mode_of):
    """The port's nets start from the flax probe's initial weights."""
    def init(self, in_dim):
        net = type(self)._orig_init(self, in_dim)
        params = self._flax.module.init(jax.random.PRNGKey(self.seed),
                                        jnp.asarray(self._example), train=False)["params"]
        net.load_state_dict(tprobes.probe_state_dict_from_flax(
            jax.tree.map(np.asarray, params), mode_of(self)))
        return net

    for cls in (tprobes.ClassificationProbe, tprobes.SequenceProbe):
        monkeypatch.setattr(cls, "_orig_init", cls._init_net, raising=False)
        monkeypatch.setattr(cls, "_init_net", init)


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_forward_from_flax_params(name):
    ref, out, x, y = _probe_pair(name)
    params = ref.module.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]), train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    net = out._init_net(x.shape[-1])
    net.load_state_dict(tprobes.probe_state_dict_from_flax(params, out.mode))
    want = np.asarray(ref.module.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_training_matches_flax(monkeypatch, name):
    """From flax's initial weights, the same batches, dropout 0: after 5
    epochs the kept weights within 1e-4 and the best validation metrics
    within 1e-5; the test metrics too.

    The attention score's bias shifts every token's score alike, which the
    softmax over the tokens cancels: its gradient is zero in exact
    arithmetic and rounding noise in both packages, which Adam's
    normalisation turns into steps of up to ~lr. It is held to the
    output's independence of it instead."""
    ref, out, x, y = _probe_pair(name)
    out._flax, out._example = ref, x[:1]
    _carry_flax_init(monkeypatch, lambda p: p.mode)
    train, val = (x[:40], y[:40]), (x[40:], y[40:])
    kw = dict(learning_rate=3e-2, max_num_epochs=5, batch_size=8)
    want = ref.train(train, val, **kw)
    got = out.train(train, val, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    expect = tprobes.probe_state_dict_from_flax(jax.tree.map(np.asarray, ref.params), out.mode)
    state = out.net.state_dict()
    assert set(state) == set(expect)
    free = {"score.bias"} if out.mode == "attention-pooling" else set()
    for k, v in expect.items():
        if k not in free:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-4, rtol=0, err_msg=k)
    if free:
        xt = torch.from_numpy(x)
        with torch.no_grad():
            before = out.net(xt)
            out.net.score.bias.add_(0.5)  # several times its drift above
            torch.testing.assert_close(out.net(xt), before, rtol=1e-6, atol=1e-6)
            out.net.score.bias.sub_(0.5)
    got, want = out.evaluate((x, y)), ref.evaluate((x, y))
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_schedule_counts_as_optax():
    import optax

    for total in (1, 7, 40, 123):
        sched = jprobes._warmup_linear_decay(1e-3, total)
        share = tprobes._warmup_linear_decay(total)
        for count in range(total + 5):
            assert 1e-3 * share(count) == pytest.approx(float(sched(count)), rel=1e-6,
                                                        abs=1e-12), count
    assert tprobes._warmup_linear_decay(40)(0) == 0.0
    import inspect

    assert inspect.signature(optax.adamw).parameters["weight_decay"].default == \
        tprobes.WEIGHT_DECAY


# --------------------------------------------------------------- end to end


@pytest.mark.parametrize("recipe,mode", [("esc50", "linear"), ("ravdess", "non-linear")])
def test_recipe_end_to_end_matches_the_jax_package(tmp_path, monkeypatch, recipe, mode):
    """A fake model, the probes from flax's initial weights and dropout 0:
    the fold-mean metrics (and their deviations) within 1e-4."""
    if recipe == "esc50":
        _make_esc50_layout(tmp_path)
        jcls, tcls = jarch.ESC50, tarch.ESC50
    else:
        _make_ravdess_layout(tmp_path)
        jcls, tcls = jarch.RAVDESS, tarch.RAVDESS
    monkeypatch.setattr(jrecipes, "ClassificationProbe",
                        partial(jprobes.ClassificationProbe, dropout=0.0))
    flax_probes = []

    def port_probe(**kw):
        probe = tprobes.ClassificationProbe(**kw, dropout=0.0)
        ref = jprobes.ClassificationProbe(**{k: v for k, v in kw.items() if k != "device"},
                                          dropout=0.0)
        probe._flax = ref
        flax_probes.append(probe)
        return probe

    def train(self, train_data, val_data, _orig=tprobes.ClassificationProbe.train, **kw):
        self._example = train_data[0][:1]
        return _orig(self, train_data, val_data, **kw)

    monkeypatch.setattr(trecipes, "ClassificationProbe", port_probe)
    monkeypatch.setattr(tprobes.ClassificationProbe, "train", train)
    _carry_flax_init(monkeypatch, lambda p: p.mode)
    kw = dict(mode=mode, max_num_epochs=20, batch_size=8, learning_rate=5e-2)
    want = jcls(str(tmp_path)).evaluate(FakeArchModel(), **kw)
    got = tcls(str(tmp_path)).evaluate(FakeArchModel(), device="cpu", **kw)
    assert flax_probes and set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert got["accuracy"] >= 0.8


def test_embedding_cache_shared_across_folds_and_modes(tmp_path):
    """Each clip goes through the model once a recipe, across folds and
    probe modes."""
    _make_esc50_layout(tmp_path)
    model = FakeArchModel()
    calls = {"n": 0}
    orig = model.get_embeddings

    def counting(audio, **kwargs):
        calls["n"] += 1
        return orig(audio, **kwargs)

    model.get_embeddings = counting
    recipe = tarch.ESC50(str(tmp_path))
    n_clips = len(recipe._all_audio_paths())
    recipe.evaluate(model, mode="linear", max_num_epochs=2, batch_size=8, device="cpu")
    assert calls["n"] == n_clips, (calls["n"], n_clips)
    recipe.evaluate(model, mode="non-linear", max_num_epochs=2, batch_size=8, device="cpu")
    assert calls["n"] == n_clips  # the second mode from the cache alone


def test_classification_dataset_pads_a_batch_to_its_longest():
    """In-memory audios, longest first, each batch padded to its longest:
    the padding enters the clip mean, as in the JAX package."""
    rng = np.random.default_rng(0)
    audios = [rng.standard_normal(n).astype(np.float32) for n in (900, 1300, 500, 1000, 700)]
    kw = dict(audios=audios, labels=[0, 1, 2, 0, 1], model=FakeArchModel(), sampling_rate=SR,
              batch_size=2)
    ref = jarch.ClassificationDataset(**kw).arrays()[0]
    out = tarch.ClassificationDataset(**kw).arrays()[0]
    np.testing.assert_array_equal(out, ref)
    alone = FakeArchModel().get_embeddings(audios[4])
    assert not np.allclose(out[4], alone)  # 700 samples padded to 900
    tok = tarch.ClassificationDataset(**kw, mode="attention-pooling").arrays()[0]
    np.testing.assert_array_equal(
        tok, jarch.ClassificationDataset(**kw, mode="attention-pooling").arrays()[0])
    assert tok.shape == (5, 13, 8)


# --------------------------------------------------------------- embeddings

TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
)


@pytest.fixture(scope="module")
def wavjepa_models():
    jc, tc = JaxConfig(**TINY), JEPAConfig(**TINY)
    # jitted: eager flax init of the model takes several times as long
    params = jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))
    params = jax.tree.map(np.asarray, params["params"])
    return (jarch.WavJEPAModel(jrt.RuntimeJEPA(jc, params)),
            tarch.WavJEPAModel(trt.RuntimeJEPA(tc, state_dict_from_jax_params(params),
                                               device="cpu")))


def test_wavjepa_model_embeddings_match_jax(wavjepa_models):
    ref, out = wavjepa_models
    rng = np.random.default_rng(4)
    clip = (0.3 * rng.standard_normal(1000)).astype(np.float32)
    for fn in ("get_embeddings", "get_token_embeddings"):
        got, want = getattr(out, fn)(clip), getattr(ref, fn)(clip)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=fn)
    batch = [(0.3 * rng.standard_normal(700)).astype(np.float32) for _ in range(3)]
    for mode in ("linear", "attention-pooling"):
        got, want = out.get_batch_embeddings(batch, mode), ref.get_batch_embeddings(batch, mode)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=mode)
    assert out.get_sampling_rate() == 1600
    assert out.get_classification_embedding_size() == out.get_token_embedding_size() == 32


def test_wavjepa_model_through_a_recipe_dataset(tmp_path, wavjepa_models):
    """The recipe's precompute (decode at 1 kHz, resample to the model's
    1.6 kHz, batches) through both packages' WavJEPA models."""
    ref, out = wavjepa_models
    _make_esc50_layout(tmp_path, folds=1, per_class=2)
    paths = sorted(str(p) for p in (tmp_path / "audio").iterdir())
    kw = dict(audio_paths=paths, labels=list(range(len(paths))), sampling_rate=1600,
              batch_size=4)
    want = jarch.ClassificationDataset(model=ref, **kw).arrays()[0]
    got = tarch.ClassificationDataset(model=out, **kw).arrays()[0]
    assert got.shape == want.shape == (len(paths), 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------- download


def test_download_registry_dry_run(tmp_path, capsys):
    from wavjepa_tpu.eval.arch import download as jdl
    from wavjepa_tpu_torch.eval.arch import download as tdl

    assert list(tdl.REGISTRY) == list(jdl.REGISTRY) and len(tdl.REGISTRY) == 12
    for name, spec in tdl.REGISTRY.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jdl.REGISTRY[name]), name
    rc = tdl.main(["--all", "--root", str(tmp_path / "ds"), "--dry-run"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "esc50" in out and "fetch" in out and "7z" in out
    assert not (tmp_path / "ds").exists()  # a dry run writes nothing
    jdl.main(["--all", "--root", str(tmp_path / "ds"), "--dry-run"])
    assert capsys.readouterr().out == out


def test_resolve_audio_path_prefers_transcoded_sibling(tmp_path):
    mp3 = tmp_path / "000002.mp3"
    assert trecipes.resolve_audio_path(str(mp3)) == str(mp3)
    (tmp_path / "000002.flac").write_bytes(b"")
    assert trecipes.resolve_audio_path(str(mp3)) == str(tmp_path / "000002.flac")
    (tmp_path / "000002.wav").write_bytes(b"")
    assert trecipes.resolve_audio_path(str(mp3)) == str(tmp_path / "000002.wav")
