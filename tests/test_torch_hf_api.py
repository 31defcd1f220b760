"""The port's HF-style surface (``api/hf.py``, ``api/hear_wavjepa_hf.py``)
and the wav2vec2-frontend HEAR module (``api/hear_wavjepa_w2v2.py``) against
the JAX package's: the contract and resample cases of tests/test_hf_api.py,
one reference-format .ckpt written from JAX params through both packages'
``WavJEPAForAudioEmbeddings`` in f32 (mono and 2-channel Nat), and the w2v2
config and a tiny w2v2 runtime. Whole model in f32: atol 5e-5, rtol 1e-4
(as tests/test_torch_runtime.py); timestamps rtol 1e-12."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api import hear_wavjepa_w2v2 as jw2v2
from wavjepa_tpu.api import hf as jhf
from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.api.convert import export_jepa_state_dict
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops.conv_frontend import WAV2VEC2_CONV_SPEC
from wavjepa_tpu.train.checkpoint import import_torch_jepa
from wavjepa_tpu_torch.api import hear_wavjepa_hf, hear_wavjepa_w2v2
from wavjepa_tpu_torch.api import hf as thf
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig

ATOL, RTOL = 5e-5, 1e-4
TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
)
NAT = dict(TINY, in_channels=2, extractor="conv_channel", pos_embed="binaural")


def _reference_ckpt(tmp_path, jc, seed):
    """A reference-format .ckpt (Lightning wrapper, tables stored) from
    freshly initialised JAX params; returns (path, params)."""
    params = jax.tree.map(np.asarray, jax.jit(JaxJEPA(jc).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, jc.in_channels, jc.target_length)))["params"])
    sd = export_jepa_state_dict(params, model_config=jc)
    path = tmp_path / f"model_{seed}.ckpt"
    torch.save({"state_dict": {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}}, path)
    return str(path), params


def test_hf_model_contract():
    model = thf.WavJEPAForAudioEmbeddings(
        trt.load_model("", config=JEPAConfig(**TINY), device="cpu"))
    fx = thf.WavJEPAFeatureExtractor(sampling_rate=1600)
    ten_seconds = 1600 * 10
    inputs = fx(0.2 * np.random.default_rng(0).standard_normal(ten_seconds).astype(np.float32))
    assert inputs.shape == (1, 1, ten_seconds)
    emb, ts = model(inputs)
    assert isinstance(emb, torch.Tensor) and emb.device.type == "cpu"
    frames = JEPAConfig(**TINY).frames_per_window
    assert emb.ndim == 3 and emb.shape[0] == 1 and emb.shape[2] == 32
    assert emb.shape[1] >= 49 * frames
    assert ts.shape == (1, emb.shape[1])
    assert ts[0, 0].item() == 0.0 and ts[0, -1].item() < 10_000.0
    diffs = np.diff(ts[0].numpy())
    np.testing.assert_allclose(diffs, diffs[0])


@pytest.mark.parametrize("in_channels,shape", [(1, (1, 16000)), (2, (1, 2, 16000))])
def test_feature_extractor_matches_jax(in_channels, shape):
    audio = 0.3 * np.random.default_rng(in_channels).standard_normal(shape).astype(np.float32)
    out = thf.WavJEPAFeatureExtractor(in_channels=in_channels)(audio)
    np.testing.assert_array_equal(out, jhf.WavJEPAFeatureExtractor(in_channels=in_channels)(audio))
    assert out.shape == (1, in_channels, 16000)
    rms = np.sqrt(np.mean(out**2))
    assert rms == pytest.approx(10 ** (-14.0 / 20.0), rel=1e-3)


def test_feature_extractor_resamples():
    fx = thf.WavJEPAFeatureExtractor(sampling_rate=1600)
    assert fx(np.ones(800, np.float32), sampling_rate=800).shape[-1] == 1600
    audio = np.random.default_rng(4).standard_normal((2, 4410)).astype(np.float32)
    out = thf.WavJEPAFeatureExtractor()(audio, sampling_rate=44100)
    ref = jhf.WavJEPAFeatureExtractor()(audio, sampling_rate=44100)
    assert out.shape == ref.shape == (2, 1, 1600)
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("kw,shape", [(TINY, (2, 2500)), (NAT, (1, 2, 2500))],
                         ids=["mono", "nat"])
def test_reference_ckpt_through_both_packages(tmp_path, kw, shape):
    jc = JaxConfig(**kw)
    path, _ = _reference_ckpt(tmp_path, jc, seed=len(shape))
    # the JAX package's load_model of a .ckpt, without its eager template init
    jmodel = jhf.WavJEPAForAudioEmbeddings(jrt.RuntimeJEPA(jc, import_torch_jepa(path, jc)[0]))
    tmodel = thf.WavJEPAForAudioEmbeddings(
        trt.load_model(path, config=JEPAConfig(**kw), device="cpu"))
    audio = 0.2 * np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    inputs = thf.WavJEPAFeatureExtractor(1600, kw.get("in_channels", 1))(audio)
    ref_emb, ref_ts = jmodel(inputs)
    emb, ts = tmodel(inputs)
    assert emb.shape == ref_emb.shape and emb.dtype == torch.float32
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), ref_ts, rtol=1e-12)


@pytest.mark.parametrize("channels", [1, 2])
def test_from_pretrained_is_load_model(tmp_path, channels):
    """``from_pretrained`` (the HEAR module's ``load_model`` too) serves what
    ``api/runtime.load_model`` serves from the same checkpoint, bit for bit,
    mono and in the Nat form."""
    cfg = JEPAConfig(size="tiny", in_channels=channels,
                     extractor="conv_channel" if channels == 2 else "conv")
    model = JEPA(cfg)
    model.init_parameters(torch.Generator().manual_seed(channels))
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": model.state_dict()}, path)
    kw = dict(in_channels=channels, channel_wise=channels == 2, model_size="tiny", device="cpu")
    hf_model = thf.WavJEPAForAudioEmbeddings.from_pretrained(str(path), **kw)
    runtime = trt.load_model(str(path), **kw)
    assert hf_model.config == runtime.config and hf_model.config.dtype == torch.bfloat16
    audio = np.random.default_rng(6).standard_normal((1, channels, 20000)).astype(np.float32)
    inputs = thf.WavJEPAFeatureExtractor(in_channels=channels)(audio)
    emb, ts = hf_model(inputs)
    ref_emb, ref_ts = runtime.get_timestamp_embeddings(inputs)
    assert torch.equal(emb, ref_emb) and torch.equal(ts, ref_ts)
    module = hear_wavjepa_hf.load_model(str(path), **kw)
    assert module.sample_rate == 16000 and module.scene_embedding_size == 32
    scene = hear_wavjepa_hf.get_scene_embeddings(inputs, module)
    assert torch.equal(scene, ref_emb.mean(dim=1))


def _module_config(module, runtime, monkeypatch, size):
    """The config a HEAR module hands to its runtime's ``load_model``."""
    seen = {}
    monkeypatch.setattr(runtime, "load_model", lambda path, config, **kw: seen.setdefault("c", config))
    module.load_model("", model_size=size)
    return seen["c"]


@pytest.mark.parametrize("size", ["base", "tiny"])
def test_w2v2_config_is_the_jax_modules(monkeypatch, size):
    jd = dataclasses.asdict(_module_config(jw2v2, jw2v2._runtime, monkeypatch, size))
    td = dataclasses.asdict(_module_config(hear_wavjepa_w2v2, hear_wavjepa_w2v2._runtime,
                                           monkeypatch, size))
    assert jd.pop("dtype") == jnp.bfloat16 and td.pop("dtype") == torch.bfloat16
    assert td == jd
    cfg = hear_wavjepa_w2v2.w2v2_config(size)
    assert cfg.target_length == 64319 and cfg.frames_per_window == 200  # int(16000 · 4.02)


def test_w2v2_runtime_matches_jax(tmp_path):
    """A reference .ckpt of a tiny-encoder w2v2 model (seeded weights),
    through the port's module and into the JAX runtime, in f32."""
    model = JEPA(hear_wavjepa_w2v2.w2v2_config("tiny"))
    model.init_parameters(torch.Generator().manual_seed(3))
    path = tmp_path / "w2v2.ckpt"
    torch.save({"state_dict": model.state_dict()}, path)
    served = hear_wavjepa_w2v2.load_model(str(path), model_size="tiny", device="cpu")
    assert served.config.dtype == torch.bfloat16 and served.unit_frames == 64319
    jc = dataclasses.replace(JaxConfig(conv_spec=WAV2VEC2_CONV_SPEC, process_seconds=4.02,
                                       size="tiny"), dtype=jnp.float32)
    jf = jrt.RuntimeJEPA(jc, import_torch_jepa(str(path), jc)[0])
    tf = trt.RuntimeJEPA(dataclasses.replace(served.config, dtype=torch.float32),
                         served.model.state_dict(), device="cpu")
    rng = np.random.default_rng(8)
    # one window of samples exactly (a whole padding window follows it) and
    # a clip one sample longer than a window
    clips = [rng.standard_normal(n).astype(np.float32) for n in (64319, 64320)]
    ref_emb, ref_ts = jf.get_timestamp_embeddings(clips)
    emb, ts = tf.get_timestamp_embeddings(clips)
    _, n_chunks, cut_off, _ = trt.chunk_padding(64320, 64319, 16000, 200)
    assert (n_chunks, cut_off) == (2, 200) == jrt.chunk_padding(64320, 64319, 16000, 200)[1:3]
    assert emb.shape == ref_emb.shape == (2, cut_off, 32)
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), ref_ts, rtol=1e-12)
    step = ts[0, 1].item()
    assert step == pytest.approx(64320 / 16000 / cut_off * 1000.0, rel=1e-12)
    assert abs(step - 20.0) <= 0.2  # 20-ms frames, on the integer-second grid
