"""WavLM on the port (``models/wavlm.py``, ``api/runtime.RuntimeWavLM``):
the plain reference (``tests/wavlm_reference.py``) against ``transformers``'
``WavLMModel`` in eval mode, the bucket function against its own, the port
against the reference on seeded weights in padded batches, the faults the
comparison has to catch, and the runtime's whole-utterance batches against
utterances served alone. All on the CPU, in float32, at a small size: 2
layers of width 128, 4 heads of 32, a 32-channel frontend with the published
kernels and strides."""

import os

os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import wavlm_reference as R  # noqa: E402
from transformers import WavLMConfig as HFConfig  # noqa: E402
from transformers import WavLMModel  # noqa: E402
from transformers.models.wavlm.modeling_wavlm import WavLMAttention as HFAttention  # noqa: E402

from wavjepa_tpu_torch.api import hear_wavlm  # noqa: E402
from wavjepa_tpu_torch.api.convert import state_dict_from_hf_wavlm  # noqa: E402
from wavjepa_tpu_torch.api.runtime import RuntimeWavLM  # noqa: E402
from wavjepa_tpu_torch.models import wavlm as W  # noqa: E402
from wavjepa_tpu_torch.utils import profiling  # noqa: E402

SMALL = dict(conv_dim=(32,) * 7, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=256)
CFG = dict(conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
           layer_norm_eps=1e-5, num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
           num_buckets=320, max_bucket_distance=800, do_normalize=True, **SMALL)
TOKENS = (64, 177, 400)
# f32 on both sides, the same operations in another order: a few ulps of the
# frames' unit scale after 2 layers, the attention over up to 400 keys
TOL = 2e-5


def samples_for(tokens: int) -> int:
    """The fewest samples that give ``tokens`` frames (receptive field 400,
    hop 320)."""
    return 400 + 320 * (tokens - 1)


def hf_weights(seed: int) -> dict:
    """Seeded weights under ``transformers``' names, at scales where every
    part moves the output: lecun-normal products, a standard-normal bucket
    embedding (scores and bias of one size), gate constants in [0.5, 1.5],
    norms away from 1 and 0, the positional convolution's weight norm as
    stored (g, v)."""
    g = torch.Generator().manual_seed(seed)
    model = WavLMModel(HFConfig(**{k: v for k, v in CFG.items() if k != "do_normalize"},
                                feat_extract_norm="layer", do_stable_layer_norm=True,
                                conv_bias=False))
    out = {}
    for name, p in model.state_dict().items():
        if name.endswith("rel_attn_embed.weight"):
            v = torch.randn(p.shape, generator=g)
        elif name.endswith("gru_rel_pos_const"):
            v = 0.5 + torch.rand(p.shape, generator=g)
        elif "layer_norm.weight" in name:
            v = 1.0 + 0.2 * torch.randn(p.shape, generator=g)
        elif name.endswith("bias") or "layer_norm.bias" in name:
            v = 0.1 * torch.randn(p.shape, generator=g)
        elif name.endswith("original0") or name.endswith("weight_g"):
            v = 1.0 + 0.3 * torch.rand(p.shape, generator=g)
        elif p.dim() >= 2:
            fan_in = p[0].numel()
            v = torch.randn(p.shape, generator=g) / np.sqrt(fan_in)
        else:
            v = torch.randn(p.shape, generator=g)
        out[name] = v
    return out


def hf_model(w: dict) -> WavLMModel:
    model = WavLMModel(HFConfig(**{k: v for k, v in CFG.items() if k != "do_normalize"},
                                feat_extract_norm="layer", do_stable_layer_norm=True,
                                conv_bias=False))
    model.load_state_dict(w, strict=True)
    return model.eval()


def port_model(w: dict) -> W.WavLM:
    model = W.WavLM(W.WavLMConfig(**SMALL, dtype=torch.float32))
    model.load_state_dict(state_dict_from_hf_wavlm(w), strict=True)
    return model.eval()


def utterances(seed: int, tokens=TOKENS) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(samples_for(t)) * rng.uniform(0.1, 3.0)).astype(np.float32)
            for t in tokens]


@pytest.mark.parametrize("tokens", TOKENS)
def test_reference_matches_transformers(tokens):
    w = hf_weights(1)
    wave = utterances(2, (tokens,))[0]
    ref = R.utterance_embeddings([wave], w, CFG)[0]
    with torch.no_grad():
        x = R.normalize(torch.from_numpy(wave))[None]
        hf = hf_model(w)(x).last_hidden_state[0]
    assert ref.shape == (tokens, CFG["hidden_size"])
    torch.testing.assert_close(ref, hf, rtol=0, atol=TOL)


def test_bucket_matches_transformers():
    rel = torch.arange(-1749, 1750)
    attn = HFAttention(1024, 16, num_buckets=320, max_distance=800)
    want = attn._relative_positions_bucket(rel)
    assert torch.equal(W.relative_position_bucket(rel, 320, 800), want)
    assert torch.equal(R.bucket(rel, 320, 800), want)
    assert want.min() == 0 and want.max() == 319


def port_frames(model, waves: list):
    """The port on a padded batch: each utterance's valid frames."""
    runtime = RuntimeWavLM(model.config, model.state_dict(), device="cpu")
    emb, _ = runtime.get_timestamp_embeddings(waves)
    return [emb[i, :n] for i, n in enumerate(runtime.valid_frames(waves))]


def test_port_matches_reference_in_padded_batches():
    w = hf_weights(3)
    waves = utterances(4)
    got = port_frames(port_model(w), waves)
    ref = R.utterance_embeddings(waves, w, CFG)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0, atol=TOL)


@pytest.mark.parametrize("fault", ["bias dropped", "gate set to 1"])
def test_faults_fail_the_tolerance(monkeypatch, fault):
    w = hf_weights(5)
    waves = utterances(6, (96, 150))
    ref = R.utterance_embeddings(waves, w, CFG)
    real = W.relbias_attention

    def faulty(q, k, v, mask, table, gate):
        if fault == "bias dropped":
            table = torch.zeros_like(table)
        else:
            gate = torch.ones_like(gate)
        return real(q, k, v, mask, table, gate)

    monkeypatch.setattr(W, "relbias_attention", faulty)
    got = port_frames(port_model(w), waves)
    worst = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert worst > 100 * TOL, worst


def test_runtime_whole_utterances_equal_utterances_alone():
    w = hf_weights(7)
    cfg = W.WavLMConfig(**SMALL, dtype=torch.float32)
    runtime = RuntimeWavLM(cfg, state_dict_from_hf_wavlm(w), device="cpu")
    waves = utterances(8, (80, 233, 131))
    batch = runtime.get_scene_embeddings(waves)
    alone = torch.cat([runtime.get_scene_embeddings([x]) for x in waves])
    assert batch.shape == (3, SMALL["hidden_size"])
    torch.testing.assert_close(batch, alone, rtol=0, atol=TOL)
    assert runtime.valid_frames(waves) == [80, 233, 131]
    # the scene embedding is the mean of the utterance's valid frames
    frames = port_frames(runtime.model, waves)
    torch.testing.assert_close(batch, torch.stack([f.mean(0) for f in frames]), rtol=0,
                               atol=1e-6)
    emb, ts = runtime.get_timestamp_embeddings(waves)
    assert emb.shape == (3, 233, SMALL["hidden_size"]) and ts.shape == (3, 233)
    assert float(ts[0, 1]) == 20.0


def test_runtime_counts_tokens_and_padding():
    runtime = RuntimeWavLM(W.WavLMConfig(**SMALL, dtype=torch.float32), device="cpu")
    waves = utterances(9, (50, 120))
    with profiling.recording() as rec:
        runtime.get_scene_embeddings(waves)
    assert rec.counters["embed.tokens"] == 240
    assert rec.counters["embed.padded_tokens"] == 70


def test_hear_module_serves_a_state_dict(tmp_path):
    w = hf_weights(10)
    path = tmp_path / "wavlm.bin"
    torch.save({f"wavlm.{k}": v for k, v in w.items()}, path)
    model = hear_wavlm.load_model(str(path), config=W.WavLMConfig(**SMALL, dtype=torch.float32),
                                  device="cpu")
    waves = utterances(11, (70,))
    emb = hear_wavlm.get_scene_embeddings(waves, model)
    ref = R.utterance_embeddings(waves, w, CFG)[0].mean(0)
    torch.testing.assert_close(emb[0], ref, rtol=0, atol=TOL)
    assert hear_wavlm.get_timestamp_embeddings(waves, model)[0].shape == (1, 70, 128)


def test_config_is_wavlm_large():
    cfg = W.WavLMConfig()
    n = sum(p.numel() for p in W.WavLM(cfg).parameters())
    assert cfg.frames(35 * 16000) == 1749
    assert 315e6 < n < 317e6
    with pytest.raises(ValueError):
        W.WavLMConfig(do_stable_layer_norm=False)
