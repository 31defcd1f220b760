"""The port's HEAR harness (``eval/embeddings.py``, ``eval/predictions.py``,
``eval/multidevice.py``, ``python -m wavjepa_tpu_torch.eval``) on tiny
synthetic tasks, as tests/test_eval_harness.py drives the JAX package's:
scene and event tasks end to end, one reference .ckpt through both
packages' embeddings runners (equal memmaps within f32 tolerance, equal file
order and labels), and the torch probe against the flax probe from the same
initial weights (weights within 1e-5, equal scores).

This file is also the HEAR module both embeddings runners import in the
parity test (``load_model``, ``get_*_embeddings`` below): a tiny model, from
a .ckpt, in either package."""

import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.eval import embeddings as jemb
from wavjepa_tpu.eval import predictions as jpred
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.train.checkpoint import import_torch_jepa
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.eval import __main__ as cli
from wavjepa_tpu_torch.eval import embeddings as temb
from wavjepa_tpu_torch.eval import predictions as tpred
from wavjepa_tpu_torch.eval.multidevice import run_commands
from wavjepa_tpu_torch.eval.score import available_scores, read_label_vocab, label_vocab_as_dict
from wavjepa_tpu_torch.eval.synthetic import (
    DCASE2016_TASK2_LAYOUT,
    ESC50_LAYOUT,
    split_files,
    write_event_task,
    write_scene_task,
)
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig

FAKE_SR = 1000  # fake_hear_module.SR
TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
)


# ---------------------------------------------------- this file as a HEAR module


def load_model(model_file_path: str = "", package: str = "torch", device=None, **kwargs):
    if package == "jax":
        jc = JaxConfig(**TINY)
        return jrt.RuntimeJEPA(jc, import_torch_jepa(model_file_path, jc)[0])
    return trt.load_model(model_file_path, config=JEPAConfig(**TINY), device=device)


def get_timestamp_embeddings(audio, model):
    return model.get_timestamp_embeddings(audio)


def get_scene_embeddings(audio, model):
    return model.get_scene_embeddings(audio)


# ---------------------------------------------------------------- end to end


def test_scene_task_end_to_end(tmp_path):
    write_scene_task(tmp_path, FAKE_SR)
    emb_dirs = temb.runner("fake_hear_module", tasks_dir=str(tmp_path / "tasks"),
                           embeddings_dir=str(tmp_path / "emb"))
    assert len(emb_dirs) == 1
    emb_dir = emb_dirs[0]
    assert (emb_dir / ".done.embeddings").exists()
    assert json.loads((emb_dir / "train.embedding-dimensions.json").read_text()) == [24, 8]
    profile = json.loads((emb_dir / "profile.embeddings.json").read_text())
    assert profile["device_max_mem_mb"] is None  # no card was used

    tpred.runner([str(emb_dir)], grid_points=2, grid="faster", device="cpu")
    scores = json.loads((emb_dir / "test.predicted-scores.json").read_text())
    assert scores["test"]["test_top1_acc"] >= 0.75  # separable tones
    assert str(emb_dir) in tpred.runner([str(emb_dir)], grid_points=2, grid="faster",
                                        device="cpu")
    # embeddings are idempotent too
    assert temb.runner("fake_hear_module", tasks_dir=str(tmp_path / "tasks"),
                       embeddings_dir=str(tmp_path / "emb")) == emb_dirs


def test_event_task_end_to_end(tmp_path):
    write_event_task(tmp_path, FAKE_SR)
    emb_dir = temb.runner("fake_hear_module", tasks_dir=str(tmp_path / "tasks"),
                          embeddings_dir=str(tmp_path / "emb"))[0]
    assert (emb_dir / "train.filename-timestamps.json").exists()
    tpred.runner([str(emb_dir)], grid_points=1, grid="faster", device="cpu")
    scores = json.loads((emb_dir / "test.predicted-scores.json").read_text())
    assert 0.0 <= scores["test"]["test_event_onset_200ms_fms_f_measure"] <= 1.0
    assert scores["test"]["test_segment_1s_er_error_rate"] >= 0.0


def test_cli_runs_both_stages_on_the_cpu(tmp_path, capsys):
    write_scene_task(tmp_path, FAKE_SR)
    cli.main(["embeddings", "fake_hear_module", "--tasks-dir", str(tmp_path / "tasks"),
              "--embeddings-dir", str(tmp_path / "emb"), "--device", "cpu"])
    emb_dir = tmp_path / "emb" / "fake_hear_module" / "tones"
    assert str(emb_dir) in capsys.readouterr().out
    cli.main(["predictions", str(emb_dir), "--grid-points", "1", "--grid", "faster",
              "--device", "cpu"])
    assert "test_top1_acc" in capsys.readouterr().out


# --------------------------------------------------- parity with the JAX package


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A reference-format .ckpt of the tiny model with seeded weights."""
    model = JEPA(JEPAConfig(**TINY))
    model.init_parameters(torch.Generator().manual_seed(4))
    path = tmp_path_factory.mktemp("ckpt") / "model.ckpt"
    torch.save({"state_dict": model.state_dict(), "epoch": 1}, path)
    return str(path)


@pytest.mark.parametrize("make_task", [write_scene_task, write_event_task],
                         ids=["scene", "event"])
def test_one_ckpt_through_both_embeddings_runners(tmp_path, reference_ckpt, make_task):
    task = make_task(tmp_path, TINY["sample_rate"])
    tasks = str(tmp_path / "tasks")
    jdir = jemb.runner(__name__, reference_ckpt, tasks, embeddings_dir=str(tmp_path / "jax"),
                       model_options={"package": "jax"})[0]
    tdir = temb.runner(__name__, reference_ckpt, tasks, embeddings_dir=str(tmp_path / "torch"),
                       model_options={"package": "torch", "device": "cpu"})[0]
    metadata = json.loads((task / "task_metadata.json").read_text())
    for split in metadata["splits"]:
        dims = json.loads((jdir / f"{split}.embedding-dimensions.json").read_text())
        assert json.loads((tdir / f"{split}.embedding-dimensions.json").read_text()) == dims
        ref = np.memmap(jdir / f"{split}.embeddings.npy", np.float32, "r", shape=tuple(dims))
        out = np.memmap(tdir / f"{split}.embeddings.npy", np.float32, "r", shape=tuple(dims))
        np.testing.assert_allclose(out, ref, atol=5e-5, rtol=1e-4)
        labels = [pickle.loads((d / f"{split}.target-labels.pkl").read_bytes())
                  for d in (jdir, tdir)]
        assert labels[1] == labels[0]
        if metadata["embedding_type"] == "event":
            # the same file order (random.Random(0)) and timestamps, each
            # under its own embeddings directory
            ft = [json.loads((d / f"{split}.filename-timestamps.json").read_text())
                  for d in (jdir, tdir)]
            assert [Path(f).name for f, _ in ft[1]] == [Path(f).name for f, _ in ft[0]]
            np.testing.assert_allclose([t for _, t in ft[1]], [t for _, t in ft[0]],
                                       rtol=1e-12)
        else:  # scene: the order shows in the labels, which differ by file
            assert len(set(map(tuple, labels[0]))) == 3


PROBE_CONF = dict(hidden_dim=16, dropout=0.0, lr=1e-3, patience=20, max_epochs=6,
                  check_val_every_n_epoch=2, initialization="xavier_uniform")


# batches of 8 rows (3 steps an epoch) for the scene task, of 64 (4 steps)
# for the event task's 200 frames. Weights within 1e-5, but 1e-4 (lr / 10)
# in the event case: the fake module's band energies there are ~0.017 ± 0.004
# in seven features and 1.2 ± 2.4 in the eighth, so the BatchNorm's
# E[x²] − E[x]² cancels and each package's f32 gradient of the first layer
# is off the f64 one by ~1e-6 (JAX 6.7e-7, the port 1.1e-6, measured on the
# first batch), ~5% of its smallest elements (~2e-5), which Adam's
# per-element normalisation turns into ~5% of lr a step
@pytest.mark.parametrize("make_task,hidden_layers,batch_size,atol", [
    (write_scene_task, 0, 8, 1e-5), (write_scene_task, 2, 8, 1e-5),
    (write_event_task, 1, 64, 1e-4)], ids=["scene_0", "scene_2", "event_1"])
def test_probe_matches_the_flax_probe(tmp_path, monkeypatch, make_task, hidden_layers,
                                      batch_size, atol):
    """The same initial weights and batches, dropout 0: every weight the loss
    depends on within ``atol``, equal validation and test scores, and the
    test split's probabilities in evaluation mode.

    A hidden Linear's bias feeds a BatchNorm, which subtracts the batch mean:
    the loss does not depend on it, so its gradient is zero in exact
    arithmetic and rounding noise in both packages, which Adam's
    normalisation turns into steps of up to ~lr. That bias, and the running
    mean that tracks it, follow that noise in either package; they are held
    to the loss's independence of them instead."""
    make_task(tmp_path, FAKE_SR)
    emb_dir = temb.runner("fake_hear_module", tasks_dir=str(tmp_path / "tasks"),
                          embeddings_dir=str(tmp_path / "emb"))[0]
    metadata = json.loads((emb_dir / "task_metadata.json").read_text())
    label_to_idx = label_vocab_as_dict(read_label_vocab(emb_dir / "labelvocabulary.csv"),
                                       key="label", value="idx")
    nlabels = len(label_to_idx)
    scores = [available_scores[s](label_to_idx=label_to_idx) for s in metadata["evaluation"]]
    split = tpred.get_splits_from_metadata(metadata)[0]
    conf = dict(PROBE_CONF, hidden_layers=hidden_layers, batch_size=batch_size)

    def flax_init(self, generator):  # the flax probe's initial weights
        params, stats = jpred.FullyConnectedProbe(
            self.nfeatures, self.nlabels, self.prediction_type, self.conf).init(42)
        self.load_state_dict(tpred.probe_state_dict_from_jax(
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)))

    monkeypatch.setattr(tpred.FullyConnectedProbe, "reset_parameters", flax_init)
    args = (emb_dir, 8, metadata, split, label_to_idx, nlabels, scores, conf)
    ref = jpred.task_predictions_train(*args, seed=42)
    out = tpred.task_predictions_train(*args, seed=42, device="cpu")
    assert out.epoch == ref.epoch and out.postprocessing == ref.postprocessing
    assert out.validation_score == ref.validation_score
    expect = tpred.probe_state_dict_from_jax(jax.tree.map(np.asarray, ref.params),
                                             jax.tree.map(np.asarray, ref.batch_stats))
    assert set(out.state_dict) == set(expect)
    ahead_of_a_norm = {f"hidden.{i}.bias" for i in range(hidden_layers)} | {
        f"norms.{i}.running_mean" for i in range(hidden_layers)}
    for k, v in expect.items():
        if k not in ahead_of_a_norm:
            np.testing.assert_allclose(out.state_dict[k].numpy(), v.numpy(), atol=atol,
                                       rtol=0, err_msg=k)
    test_args = (metadata, split, label_to_idx, nlabels, scores)
    assert tpred.task_predictions_test(emb_dir, out, *test_args, device="cpu") == \
        jpred.task_predictions_test(emb_dir, ref, *test_args)
    # evaluation mode (running statistics) on the test split, against the
    # flax probe's probabilities: from the flax probe's own trained state
    # carried into the port, to f32 rounding (measured ≤ 1.2e-7); and from
    # the port's trained state, whose hidden biases and running means drift
    # apart as above (bias − running mean by up to 4.4e-3, probabilities by
    # up to 2.2e-3, measured), within 1e-2. Normalising by the batch's
    # statistics in evaluation mode moves the logits by 0.4-1.2 here.
    test = tpred.SplitData(emb_dir, split["test"], label_to_idx, nlabels,
                           metadata["embedding_type"])
    _, _, predict = jpred.FullyConnectedProbe(
        8, nlabels, metadata["prediction_type"], conf).make_steps(conf["lr"])
    ref_probs = np.asarray(predict(ref.params, ref.batch_stats, jnp.asarray(test.x))[1])
    probe = tpred.FullyConnectedProbe(8, nlabels, metadata["prediction_type"], conf)
    for state, tol in ((expect, 1e-6), (out.state_dict, 1e-2)):
        probe.load_state_dict(state)
        np.testing.assert_allclose(probe.predict(torch.from_numpy(test.x)), ref_probs,
                                   atol=tol, rtol=0)
    if hidden_layers:  # the training loss does not move with those biases
        probe = tpred.FullyConnectedProbe(8, nlabels, metadata["prediction_type"], conf)
        probe.load_state_dict(out.state_dict)
        train = tpred.SplitData(emb_dir, split["train"], label_to_idx, nlabels,
                                metadata["embedding_type"])
        x, y = torch.from_numpy(train.x[:64]), torch.from_numpy(train.y[:64])
        with torch.no_grad():
            before = probe.train().loss(probe(x), y)
            for lin in probe.hidden:
                lin.bias.add_(0.5)  # a hundred times their drift above
            after = probe.loss(probe(x), y)
        torch.testing.assert_close(after, before, rtol=1e-6, atol=0)


def test_batchnorm_running_variance_is_flaxs_biased_one():
    """The running variance moves toward the batch's biased variance
    (flax), not the unbiased one (``nn.BatchNorm1d``)."""
    x = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
    norm = tpred.ProbeBatchNorm(3).train()
    norm(x)
    biased = x.var(0, unbiased=False)
    torch.testing.assert_close(norm.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(norm.running_mean, 0.1 * x.mean(0))
    ref = torch.nn.BatchNorm1d(3, momentum=0.1).train()
    ref(x)
    assert not torch.allclose(ref.running_var, norm.running_var)


def test_the_public_task_layouts(tmp_path):
    """ESC50_LAYOUT and DCASE2016_TASK2_LAYOUT write the clip counts, clip
    lengths, labels and splits they name (at 1 kHz here: only the layout
    is checked); each event lies inside its clip and its own 4-s slot."""
    esc = write_scene_task(tmp_path, FAKE_SR, **ESC50_LAYOUT)
    meta = json.loads((esc / "task_metadata.json").read_text())
    assert split_files(esc) == {f"fold{i:02d}": 400 for i in range(5)}
    assert meta["split_mode"] == "presplit_kfold" and meta["sample_duration"] == 5.0
    assert len(read_label_vocab(esc / "labelvocabulary.csv")) == 50
    assert len(tpred.get_splits_from_metadata(meta)) == 5
    dcase = write_event_task(tmp_path, FAKE_SR, **DCASE2016_TASK2_LAYOUT)
    meta = json.loads((dcase / "task_metadata.json").read_text())
    assert split_files(dcase) == {"train": 36, "valid": 18, "test": 18}
    assert meta["sample_duration"] == 120.0 and meta["embedding_type"] == "event"
    assert len(read_label_vocab(dcase / "labelvocabulary.csv")) == 11
    for split in meta["splits"]:
        for events in json.loads((dcase / f"{split}.json").read_text()).values():
            assert len(events) == 30
            for slot, e in enumerate(events):
                assert slot * 4000 <= e["start"] < e["end"] <= (slot + 1) * 4000
    wav = dcase / str(FAKE_SR) / "test" / "test_0.wav"
    assert wav.stat().st_size == 44 + 2 * 120 * FAKE_SR  # 16-bit PCM, 120 s


def test_run_commands_pins_each_command_to_one_card(tmp_path):
    cmds = [f"echo dev-$CUDA_VISIBLE_DEVICES-${{TPU_VISIBLE_CHIPS:-none}} > {tmp_path}/out_{i}.txt"
            for i in range(4)]
    assert run_commands(cmds, num_devices=2) == [0, 0, 0, 0]
    devices = [(tmp_path / f"out_{i}.txt").read_text().strip() for i in range(4)]
    assert all(d in ("dev-0-none", "dev-1-none") for d in devices), devices
