"""The port's X-ARES surface (``wavjepa_tpu_torch/eval/xares``) against the
JAX package's (``wavjepa_tpu/eval/xares``), on the CPU, at the small
configuration of tests/test_xares.py: the encoder contract and its frame
math; encoder outputs from the same JEPA weights within the runtime's f32
tolerance (atol 5e-5, rtol 1e-4); class discovery in the port's
``encoder.py``; the kNN leg equal; both linear probes from the same initial
(w, b) within 1e-4 after 300 full-batch Adam steps; mAP equal to the JAX
package's scikit-learn branch within 1e-12; and the stub task and the task
protocol (accuracy with its kNN leg, and mAP) end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.eval.xares import WavJEPAEncoder as JaxEncoder
from wavjepa_tpu.eval.xares import run as jrun
from wavjepa_tpu.eval.xares import vendored_protocol as jvp
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.eval.xares import WavJEPAEncoder, check_audio_encoder
from wavjepa_tpu_torch.eval.xares import run as trun
from wavjepa_tpu_torch.eval.xares import vendored_protocol as tvp
from wavjepa_tpu_torch.models.jepa import JEPAConfig

ATOL, RTOL = 5e-5, 1e-4  # tests/test_torch_runtime.py's whole-model f32 tolerance
SMALL = dict(  # tests/test_xares.py's configuration
    conv_spec=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_layers=2,
    encoder_dim=64,
    encoder_heads=4,
    decoder_layers=1,
    decoder_dim=32,
    decoder_heads=4,
    sample_rate=1600,
    process_seconds=0.201,
)


@pytest.fixture(scope="module")
def encoders():
    jc, tc = JaxConfig(**SMALL), JEPAConfig(**SMALL)
    # jitted: eager flax init of the model takes several times as long
    params = jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))
    params = jax.tree.map(np.asarray, params["params"])
    return (JaxEncoder(runtime=jrt.RuntimeJEPA(jc, params)),
            WavJEPAEncoder(runtime=trt.RuntimeJEPA(tc, state_dict_from_jax_params(params),
                                                   device="cpu")))


def test_encoder_contract_and_frame_math(encoders):
    ref, enc = encoders
    assert check_audio_encoder(enc)
    assert (enc.sampling_rate, enc.output_dim) == (1600, 64)
    cfg = JEPAConfig(**SMALL)
    expected_hop = 1000.0 * (cfg.target_length / cfg.frames_per_window) / 1600
    assert abs(enc.hop_size_in_ms - expected_hop) < 1e-6
    assert enc.hop_size_in_ms == ref.hop_size_in_ms
    out = enc(torch.zeros(2, cfg.target_length))  # one exact window
    assert out.shape == (2, cfg.frames_per_window, 64)
    assert out.device.type == "cpu" and out.dtype == torch.float32


@pytest.mark.parametrize("shape", [(1, 800), (2, 4960), (3, 321), (321,)])
def test_encoder_outputs_match_jax(encoders, shape):
    ref, enc = encoders
    audio = torch.from_numpy(np.random.default_rng(len(shape) + shape[0]).standard_normal(shape)
                             .astype(np.float32))
    want, got = ref(audio), enc(audio)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_encoder_class_discovery():
    """xares.run finds the encoder class by inspecting the module file: the
    port's encoder.py defines exactly one nn.Module."""
    import wavjepa_tpu_torch.eval.xares.encoder as encmod

    cls = tvp.discover_encoder_class(encmod.__file__)
    assert cls.__name__ == "WavJEPAEncoder" and issubclass(cls, torch.nn.Module)


@pytest.mark.parametrize("k", [1, 5, 10, 200])
def test_knn_classify_equals_jax(k):
    rng = np.random.default_rng(k)
    centers = rng.standard_normal((5, 16)) * 2.0
    y_tr = rng.integers(0, 5, 120)
    x_tr = (centers[y_tr] + rng.standard_normal((120, 16))).astype(np.float32)
    x_te = (centers[rng.integers(0, 5, 40)] + 1.5 * rng.standard_normal((40, 16))).astype(
        np.float32) * rng.uniform(0.5, 2.0, (40, 1)).astype(np.float32)
    got = tvp.knn_classify(x_tr, y_tr, x_te, k=k, device="cpu")
    np.testing.assert_array_equal(got, jvp.knn_classify(x_tr, y_tr, x_te, k=k))


def _probe_data(seed, multilabel=False, n=96, d=24, c=5):
    rng = np.random.default_rng(seed)
    if multilabel:
        y = (rng.random((n, c)) < 0.35).astype(np.float32)
        x = y @ rng.standard_normal((c, d)) + rng.standard_normal((n, d))
    else:
        y = rng.integers(0, c, n)
        x = rng.standard_normal((c, d))[y] + 1.5 * rng.standard_normal((n, d))
    return (3.0 + 2.0 * x).astype(np.float32), y


@pytest.mark.parametrize("multilabel", [False, True], ids=["softmax", "sigmoid"])
def test_linear_probes_from_the_same_start_match_jax(multilabel):
    """The JAX package's probe from its own 0.01 · N(0, 1) start; the port's
    fit from the same (w, b): within 1e-4 after 300 steps."""
    x, y = _probe_data(7, multilabel)
    c = y.shape[1] if multilabel else int(y.max()) + 1
    if multilabel:
        (jw, jb), (jmu, jsd), jloss = jvp._train_probe_multilabel(x, y, seed=3)
        loss_fn = torch.nn.functional.binary_cross_entropy_with_logits
    else:
        (jw, jb), (jmu, jsd), jloss = jrun._train_probe(x, y, c, seed=3)
        loss_fn = torch.nn.functional.cross_entropy
    w0 = torch.from_numpy(np.array(0.01 * jax.random.normal(jax.random.PRNGKey(3), (x.shape[1], c))))
    (w, b), (mu, sd), loss = trun._fit_probe(x, y.astype(np.float32) if multilabel else y, w0,
                                             torch.zeros(c), loss_fn, 300, 1e-2, "cpu")
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sd, jsd)
    np.testing.assert_allclose(w, np.asarray(jw), atol=1e-4, rtol=0)
    np.testing.assert_allclose(b, np.asarray(jb), atol=1e-4, rtol=0)
    assert loss == pytest.approx(jloss, abs=1e-4)


def test_probe_initialiser_and_wrappers():
    w, b = trun._init_probe(24, 5, seed=3)
    w2, _ = trun._init_probe(24, 5, seed=3)
    assert w.shape == (24, 5) and torch.equal(w, w2) and not b.any()
    assert 0.005 < w.std().item() < 0.015
    x, y = _probe_data(8)
    params, _, loss = trun._train_probe(x, y, 5, device="cpu")
    assert params[0].shape == (24, 5) and np.isfinite(loss)
    xm, ym = _probe_data(9, multilabel=True)
    params, _, loss = tvp._train_probe_multilabel(xm, ym, device="cpu")
    assert params[0].shape == (24, 5) and np.isfinite(loss)


@pytest.mark.parametrize("seed", range(3))
def test_mean_average_precision_equals_the_scikit_learn_branch(seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.standard_normal((64, 7)), 1)  # tied scores
    targets = (rng.uniform(size=(64, 7)) < 0.3).astype(np.float32)
    targets[:, 4] = 0.0  # a class without positives is left out
    got = tvp.mean_average_precision(scores, targets)
    assert got == pytest.approx(jvp.mean_average_precision(scores, targets), abs=1e-12)


def test_stub_task_end_to_end(encoders):
    _, enc = encoders
    result = trun.run_stub_task(enc, seed=0, device="cpu")
    assert result["metric"] == "accuracy" and result["n_test"] > 0
    assert np.isfinite(result["train_loss"])
    # tones at octave spacing are linearly separable even from a random
    # conv+transformer encoder's mean-pooled features
    assert result["value"] > 0.5, result


def _tones(sr, rng, n_per_class, names):
    out = []
    for k, name in enumerate(names):
        for _ in range(n_per_class):
            t = np.arange(int(sr * rng.uniform(0.4, 0.9))) / sr
            wav = rng.uniform(0.4, 0.9) * np.sin(2 * np.pi * 110.0 * 2.0 ** k * t
                                                 + rng.uniform(0, 6.28))
            out.append({"audio": (wav + 0.05 * rng.standard_normal(t.size)).astype(np.float32),
                        "label": name})
    rng.shuffle(out)
    return out


def test_task_protocol_accuracy_end_to_end(encoders):
    _, enc = encoders
    rng = np.random.default_rng(0)
    names = ["dog", "rain", "siren", "chirp"]
    cfg = tvp.TaskConfig(encoder=enc, name="tones4", output_dim=4,
                         label_processor=lambda s: s["label"], crop_length_s=0.6,
                         batch_size_encode=8, learning_rate=1e-2, epochs=10)
    splits = {s: _tones(1600, rng, n, names) for s, n in (("train", 16), ("valid", 4),
                                                          ("test", 6))}
    result = tvp.run_task_protocol(cfg, splits, device="cpu")
    assert result["metric"] == "accuracy" and result["n_test"] == 24
    assert result["value"] > 0.5 and result["knn_accuracy"] > 0.5, result
    x, y = tvp.encode_split(cfg, splits["test"])
    assert x.shape == (24, 64) and x.dtype == np.float32 and list(y) == [
        s["label"] for s in splits["test"]]


def test_task_protocol_map_end_to_end(encoders):
    _, enc = encoders
    rng = np.random.default_rng(1)
    cfg = tvp.config_fsd50k(enc)
    cfg.crop_length_s, cfg.batch_size_encode = 0.6, 8

    def make(n):
        out = []
        for _ in range(n):
            k = sorted(rng.choice(4, size=int(rng.integers(1, 3)), replace=False))
            t = np.arange(int(1600 * rng.uniform(0.5, 0.9))) / 1600
            wav = sum(rng.uniform(0.3, 0.7) * np.sin(2 * np.pi * 110.0 * 2.0 ** c * t)
                      for c in k) + 0.05 * rng.standard_normal(t.size)
            out.append({"audio": wav.astype(np.float32), "labels": [int(c) for c in k]})
        return out

    splits = {"train": make(96), "valid": make(8), "test": make(48)}
    result = tvp.run_task_protocol(cfg, splits, device="cpu")
    assert result["metric"] == "mAP" and "knn_accuracy" not in result
    chance = float(np.mean([cfg.label_processor(s)[:4].mean() for s in splits["test"]]))
    assert result["value"] > chance + 0.25, (result, chance)
    assert cfg.output_dim == 200 and tvp.config_esc50(enc).output_dim == 50
