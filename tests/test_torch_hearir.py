"""The port's heaRIR (scene and noise iterators, the eval-time augmenter)
against the JAX package's: the same seeds, scene specs, RIR and noise files
(those of tests/test_api_aux.py) give equal outputs, with binaural (2-channel)
and ambisonic (4-channel) RIRs; resampled noise within the native
resampler's 2e-6."""

import json

import numpy as np
import pytest

from wavjepa_tpu.api import hearir as jhearir
from wavjepa_tpu_torch.api import hearir as thearir

RIR_TYPES = ["binaural", "ambisonic"]
CHANNELS = {"binaural": 2, "ambisonic": 4}


def _write_scene_spec(tmp_path, rir_type="binaural", n_noise=2):
    channels = CHANNELS[rir_type]
    key = f"{rir_type}_rir_path"
    rng = np.random.default_rng(0)
    rirs = []
    for i in range(1 + n_noise):
        rir = np.zeros((channels, 400), np.float32)
        rir[:, 0] = 1.0
        rir[:, 1:50] = 0.02 * rng.standard_normal((channels, 49))
        p = tmp_path / f"rir_{i}.npy"
        np.save(p, rir)
        rirs.append(str(p))
    regions = [{"region": {"scene": {
        "source": {"rir": {key: rirs[k]}},
        "noise": [{"rir": {key: r}} for r in rirs[k + 1:]]}}}
        for k in range(n_noise)]  # a second region with fewer noise sources
    spec_path = tmp_path / "scene.json"
    spec_path.write_text(json.dumps({"sampled_regions": regions}))
    return str(spec_path)


def _write_noise(tmp_path, sr):
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    for i in range(3):
        wavfile.write(tmp_path / f"n{i}.wav", sr,
                      (0.1 * rng.standard_normal(500 + 300 * i) * 32000).astype(np.int16))
    return str(tmp_path)


@pytest.mark.parametrize("rir_type", RIR_TYPES)
def test_scene_iterators_draw_the_same_scenes(tmp_path, rir_type):
    spec = _write_scene_spec(tmp_path, rir_type)
    its = [pkg.SceneIterator([spec], rir_type=rir_type, sr=1000, rir_seconds=0.5, seed=4)
           for pkg in (jhearir, thearir)]
    for _ in range(6):
        (js, jn, jm), (ts, tn, tm) = (next(it) for it in its)
        assert ts.shape == (CHANNELS[rir_type], 500) and len(tn) == len(jn)
        np.testing.assert_array_equal(ts, js)
        for a, b in zip(tn, jn):
            np.testing.assert_array_equal(a, b)
        assert tm == jm


@pytest.mark.parametrize("noise_sr", [1000, 1600])  # 1600 Hz is resampled to 1000
def test_noise_iterators_match(tmp_path, noise_sr):
    noise_dir = _write_noise(tmp_path, noise_sr)
    its = [pkg.NoiseIterator(noise_dir, sr=1000, seed=2) for pkg in (jhearir, thearir)]
    for _ in range(5):
        ref, out = (next(it) for it in its)
        assert out.dtype == np.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("rir_type", RIR_TYPES)
@pytest.mark.parametrize("noise_seconds,snr", [(2.0, 5.0), (0.5, 0.0), (3.0, -3.0),
                                               (None, None)])
def test_augmenter_matches(tmp_path, noise_seconds, snr, rir_type):
    spec = _write_scene_spec(tmp_path, rir_type)
    rng = np.random.default_rng(1)
    audio = rng.standard_normal(2000).astype(np.float32)
    noise = (rng.standard_normal(int(1000 * noise_seconds)).astype(np.float32)
             if noise_seconds else None)
    outs = []
    for pkg in (jhearir, thearir):
        it = pkg.SceneIterator([spec], rir_type=rir_type, sr=1000, rir_seconds=0.5, seed=3)
        aug = pkg.Augmenter(it, sr=1000, snr=snr, seed=5)
        outs.append([aug.augment(audio, noise) for _ in range(3)])
    for ref, out in zip(*outs):
        assert out.shape == (CHANNELS[rir_type], 2000)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("rir_type", RIR_TYPES)
def test_augmenter_draws_noise_from_its_iterator(tmp_path, rir_type):
    spec = _write_scene_spec(tmp_path, rir_type)
    noise_dir = _write_noise(tmp_path, 1000)
    audio = np.random.default_rng(2).standard_normal(1500).astype(np.float32)
    outs = []
    for pkg in (jhearir, thearir):
        aug = pkg.Augmenter(
            pkg.SceneIterator([spec], rir_type=rir_type, sr=1000, rir_seconds=0.5, seed=1),
            sr=1000, snr=2.0, noise_iter=pkg.NoiseIterator(noise_dir, sr=1000, seed=1), seed=1)
        outs.append(np.stack([aug.augment(audio) for _ in range(4)]))
    assert outs[1].shape == (4, CHANNELS[rir_type], 1500)
    np.testing.assert_array_equal(outs[1], outs[0])
    # pass-through without a scene iterator
    np.testing.assert_array_equal(thearir.Augmenter(None, sr=1000, snr=None).augment(audio)[0],
                                  audio)
