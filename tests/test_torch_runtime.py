"""The port's HEAR runtime against the JAX package's: window arithmetic,
host-side input preparation, timestamp and scene embeddings on a ragged
batch whose longest clip is an exact multiple of the window, and loading a
reference-format .ckpt. Whole model in f32: atol 5e-5, rtol 1e-4 (see
test_torch_model.py for why that is looser than the op tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api import feature_helper as jfh
from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.api.convert import detect_pos_embed as jax_detect_pos_embed
from wavjepa_tpu.api.convert import export_jepa_state_dict
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu_torch.api import feature_helper as tfh
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.api.convert import detect_pos_embed, state_dict_from_jax_params
from wavjepa_tpu_torch.models.jepa import JEPAConfig

ATOL, RTOL = 5e-5, 1e-4
TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
)
UNIT = JaxConfig(**TINY).target_length  # 321 samples


@pytest.fixture(scope="module")
def runtimes():
    jc, tc = JaxConfig(**TINY), JEPAConfig(**TINY)
    params = JaxJEPA(jc).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))
    params = jax.tree.map(np.asarray, params["params"])
    return (jrt.RuntimeJEPA(jc, params),
            trt.RuntimeJEPA(tc, state_dict_from_jax_params(params), device="cpu"),
            params, jc, tc)


def _clips(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("lengths", [
    [100, 500, 2 * UNIT],  # longest is an exact multiple: a whole padding window
    [UNIT],                # exactly one window
    [50, 3 * UNIT + 7, 1000],
])
def test_timestamp_embeddings_match_jax(runtimes, lengths):
    jr, tr, *_ = runtimes
    clips = _clips(lengths, seed=len(lengths))
    ref_emb, ref_ts = jr.get_timestamp_embeddings(clips)
    emb, ts = tr.get_timestamp_embeddings(clips)
    assert emb.shape == ref_emb.shape and emb.dtype == torch.float32
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), ref_ts, rtol=1e-12)


def test_scene_embeddings_match_jax(runtimes):
    jr, tr, *_ = runtimes
    batch = np.stack(_clips([700] * 3, seed=5))  # a (B, T) array input
    ref = jr.get_scene_embeddings(batch)
    out = tr.get_scene_embeddings(torch.from_numpy(batch))
    assert out.shape == (3, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("unit,sr,steps", [
    (int(2.01 * 16000), 16000, 200),  # the HEAR window (32159 samples)
    (32160, 16000, 200),              # the reference's window
    (160000, 16000, 999),             # whole clip
    (321, 1600, 31),                  # a sub-second window
])
def test_chunk_padding_matches_jax(unit, sr, steps):
    lengths = {int(s * sr) for s in np.arange(0.05, 31.0, 0.37)}
    lengths |= {m * unit + off for m in (1, 2, 5) for off in (-1, 0, 1)}
    for n in sorted(lengths):
        assert trt.chunk_padding(n, unit, sr, steps) == jrt.chunk_padding(n, unit, sr, steps), n


@pytest.mark.parametrize("unit", [int(2.01 * 16000), 32160])
def test_exact_window_gains_a_padding_window(unit):
    # pad_steps = int(unit / 16000 · 100): 32160/16000·100 is 200.99999999999997
    # in floating point, so the cut keeps 200 rows, not the 199 that exact
    # arithmetic would give
    assert trt.chunk_padding(unit, unit, 16000, 200) == (unit, 2, 200, 400)
    assert jrt.chunk_padding(unit, unit, 16000, 200) == (unit, 2, 200, 400)


def test_feature_helper_matches_jax():
    rng = np.random.default_rng(1)
    for shape, ch in (((300,), 1), ((2, 300), 1), ((300, 2), 2), ((4, 300), 2), ((1, 300), 4)):
        x = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(tfh.adapt_channels(x, ch), jfh.adapt_channels(x, ch))
    with pytest.raises(ValueError):
        tfh.adapt_channels(np.zeros((3, 50), np.float32), 1)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (100, 250, 40)]
    waves.append(np.zeros(60, np.float32))  # silence keeps its zero gain
    np.testing.assert_array_equal(tfh.prepare_batch(waves, 1), jfh.prepare_batch(waves, 1))


def test_reference_ckpt_loads_in_both_packages(runtimes, tmp_path):
    _, _, params, jc, tc = runtimes
    sd = export_jepa_state_dict(params, model_config=jc)
    # a Lightning wrapper with torch.compile prefixes, as reference runs save
    blob = {"state_dict": {k.replace("encoder.", "encoder._orig_mod.", 1): torch.tensor(v)
                           for k, v in sd.items()},
            "epoch": 3}
    path = tmp_path / "model.ckpt"
    torch.save(blob, path)
    jr = jrt.load_model(str(path), config=jc)
    tr = trt.load_model(str(path), config=tc, device="cpu")
    clips = _clips([400, 900], seed=9)
    ref, _ = jr.get_timestamp_embeddings(clips)
    out, _ = tr.get_timestamp_embeddings(clips)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    args = (jc.encoder_dim, jc.frames_per_window, jc.total_patches)
    assert detect_pos_embed(blob, *args) == jax_detect_pos_embed(sd, *args) == "time"


def test_sidecar_serves_bf16_unpacked_and_an_explicit_pos_embed_wins(tmp_path):
    # a checkpoint trained in f32 with packing: the sidecar's architecture is
    # served as the JAX package serves it (api/runtime.py:269-277), in bf16
    # without packing, and pos_embed / process_seconds given here win
    import dataclasses

    from wavjepa_tpu_torch.train.config import Config, apply_overrides
    from wavjepa_tpu_torch.train.loop import train_jepa

    # the AudioSet window (200 tokens, so packing 88/128) through a narrow
    # frontend of the same strides, and the tiny transformer
    cfg = apply_overrides(Config(), [
        "data.synthetic=true", "trainer.size=tiny", "trainer.batch_size=1",
        "data.samples_per_audio=2", "data.target_seconds=3.0",
        "extractor.conv_spec=[[16,10,5],[16,3,2],[16,3,2],[16,3,2],[16,3,2],[16,2,2],[16,2,2]]",
        "trainer.average_top_k_layers=2", "trainer.precision=f32",
        "trainer.attn_impl_decoder=fused_block", f"trainer.save_dir={tmp_path}",
    ])
    trained = cfg.build_model_config()
    assert trained.dtype == torch.float32 and trained.pack_encoder is not None
    train_jepa(cfg, max_steps=1, device="cpu")
    ckpt = tmp_path / cfg.run_identity() / "ckpt" / "step_00000001.ckpt"
    rt = trt.load_model(str(ckpt), device="cpu")
    assert rt.config == dataclasses.replace(trained, dtype=torch.bfloat16, pack_encoder=None,
                                            pack_decoder=None)
    assert rt.config.attn_impl_decoder == "fused_block"
    emb, _ = rt.get_timestamp_embeddings(_clips([500], seed=3))
    assert torch.isfinite(emb).all()
    rt = trt.load_model(str(ckpt), pos_embed="binaural", process_seconds=0.5, device="cpu")
    assert (rt.config.pos_embed, rt.config.process_seconds) == ("binaural", 0.5)
    assert rt.config.dtype == torch.bfloat16 and rt.config.pack_decoder is None
