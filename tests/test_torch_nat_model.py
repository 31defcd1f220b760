"""WavJEPA-Nat's model side in the port against the JAX package's: the
per-channel conv frontend (a stack a channel, or one shared) at 2 and 4
channels through ``state_dict_from_jax_params``; its names, which the JAX
package's reader of reference checkpoints takes; and the HEAR runtime's
timestamp and scene embeddings against ``wavjepa_tpu.api.runtime`` with a
per-channel model (``load_model(channel_wise=True)``'s configuration), at
2 channels with binaural positions and at 4 with time positions. f32;
frontend atol 2e-5, rtol 1e-4; whole model atol 5e-5, rtol 1e-4, as
tests/test_torch_frontend.py and tests/test_torch_runtime.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.api.convert import convert_jepa_state_dict
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops import conv_frontend as jcf
from wavjepa_tpu_torch.api import hear_natjepa
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops import conv_frontend as tcf

SPEC = ((16, 10, 5), (16, 3, 2), (8, 2, 2))
TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
    extractor="conv_channel",
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("channels", [2, 4])
@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_channel_frontend_matches_jax(channels, share, mode):
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((3, channels, 400)).astype(np.float32)
    jmod = jcf.ConvChannelFeatureExtractor(conv_spec=SPEC, in_channels=channels, mode=mode,
                                           share_weights=share)
    params = _np_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    port = tcf.ConvChannelFeatureExtractor(SPEC, channels, mode, share_weights=share)
    sd = state_dict_from_jax_params({"extract_audio": params,
                                     "feature_norms": {"scale": 0, "bias": 0},
                                     "encoder": {"norm": {"scale": 0, "bias": 0}}},
                                    extractor_mode=mode)
    port.load_state_dict({k.removeprefix("extract_audio."): v for k, v in sd.items()
                          if k.startswith("extract_audio.")})
    out = port(torch.from_numpy(x)).detach().numpy()
    frames = tcf.conv_output_length(400, SPEC)
    assert out.shape == ref.shape == (3, channels * frames, 8)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
    # channel-major tokens: channel 1's frames follow all of channel 0's
    solo = port(torch.from_numpy(x[:, 1:2].repeat(channels, axis=1))).detach().numpy()
    np.testing.assert_allclose(out[:, frames:2 * frames], solo[:, frames:2 * frames]
                               if not share else solo[:, :frames], atol=1e-6)


def test_channel_frontend_names_follow_the_reference():
    names = set(tcf.ConvChannelFeatureExtractor(SPEC, 2).state_dict())
    assert {"cnns.0.0.0.weight", "cnns.1.0.0.weight", "cnns.1.0.2.bias",
            "cnns.1.2.0.weight"} <= names
    shared = set(tcf.ConvChannelFeatureExtractor(SPEC, 4, share_weights=True).state_dict())
    assert all(n.startswith("cnns.0.") for n in shared)


@pytest.mark.parametrize("share", [False, True])
def test_a_reference_format_nat_state_dict_reads_back_in_the_jax_package(share):
    jc = JaxConfig(**TINY, in_channels=2, share_weights_over_channels=share)
    params = _np_tree(jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 2, jc.target_length)))["params"])
    sd = {k: v.numpy() for k, v in state_dict_from_jax_params(params).items()}
    back, _ = convert_jepa_state_dict(sd, encoder_layers=2, decoder_layers=1, conv_layers=2,
                                      channel_wise=True, in_channels=2, share_weights=share)
    flat = jax.tree_util.tree_leaves_with_path
    got = dict(flat(back))
    for path, leaf in flat(params):
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    model = JEPA(JEPAConfig(**TINY, in_channels=2, share_weights_over_channels=share))
    model.load_state_dict(state_dict_from_jax_params(params))  # every name, strictly


@pytest.fixture(scope="module", params=[(2, "binaural"), (4, "time")])
def nat_runtimes(request):
    channels, pos = request.param
    jc = JaxConfig(**TINY, in_channels=channels, pos_embed=pos)
    tc = JEPAConfig(**TINY, in_channels=channels, pos_embed=pos)
    params = _np_tree(jax.jit(JaxJEPA(jc).init)(
        jax.random.PRNGKey(channels), jnp.zeros((1, channels, jc.target_length)))["params"])
    return (jrt.RuntimeJEPA(jc, params),
            trt.RuntimeJEPA(tc, state_dict_from_jax_params(params), device="cpu"), channels)


def _clips(lengths, channels, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((channels, n)).astype(np.float32) for n in lengths]


def test_nat_timestamp_and_scene_embeddings_match_jax(nat_runtimes):
    jr, tr, channels = nat_runtimes
    assert tr.average_channels and jr.average_channels
    unit = tr.unit_frames
    for lengths in ([100, 500, 2 * unit], [unit], [3 * unit + 7]):
        clips = _clips(lengths, channels, seed=len(lengths))
        ref_emb, ref_ts = jr.get_timestamp_embeddings(clips)
        emb, ts = tr.get_timestamp_embeddings(clips)
        # channel-averaged: the mono model's steps a window
        assert emb.shape == ref_emb.shape and emb.shape[-1] == tr.embedding_size
        np.testing.assert_allclose(emb.numpy(), ref_emb, atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(ts.numpy(), ref_ts, rtol=1e-12)
    clips = _clips([700, 300], channels, seed=9)
    np.testing.assert_allclose(tr.get_scene_embeddings(clips).numpy(),
                               jr.get_scene_embeddings(clips), atol=5e-5, rtol=1e-4)


def test_hear_natjepa_serves_a_per_channel_model_on_the_cpu():
    rt = hear_natjepa.load_model("", device="cpu", model_size="tiny", pos_embed="binaural")
    cfg = rt.config
    assert (cfg.extractor, cfg.in_channels, cfg.pos_embed) == ("conv_channel", 2, "binaural")
    assert cfg.total_patches == 2 * cfg.frames_per_window
    clips = _clips([16000, 40000], 2, seed=3)
    emb, ts = hear_natjepa.get_timestamp_embeddings(clips, rt)
    assert emb.shape[0] == 2 and emb.shape[-1] == rt.embedding_size and ts.shape == emb.shape[:2]
    assert torch.isfinite(emb).all()
    scene = hear_natjepa.get_scene_embeddings(clips, rt)
    torch.testing.assert_close(scene, emb.mean(dim=1))
    # mono input is spread over the channels, as the JAX package's helper does
    assert hear_natjepa.get_scene_embeddings([clips[0][0]], rt).shape == (1, rt.embedding_size)


def test_nat_checkpoint_serves_through_the_sidecar(tmp_path):
    """A Nat training run's checkpoint and model_config.json serve the
    per-channel model in bf16, unpacked, the positions kept."""
    from wavjepa_tpu_torch.train.checkpoint import write_model_config

    cfg = JEPAConfig(**TINY, in_channels=2, pos_embed="binaural", pack_encoder=8,
                     pack_decoder=16)
    model = JEPA(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    write_model_config(tmp_path, cfg)
    (tmp_path / "ckpt").mkdir()
    torch.save({"state_dict": model.state_dict()}, tmp_path / "ckpt" / "step_00000001.ckpt")
    rt = hear_natjepa.load_model(str(tmp_path / "ckpt" / "step_00000001.ckpt"), device="cpu")
    assert rt.config.extractor == "conv_channel" and rt.config.pos_embed == "binaural"
    assert rt.config.dtype == torch.bfloat16 and rt.config.pack_encoder is None
    f32 = trt.RuntimeJEPA(dataclasses.replace(cfg, pack_encoder=None, pack_decoder=None),
                          model.state_dict(), device="cpu")
    clips = _clips([500], 2, seed=4)
    a, b = rt.get_scene_embeddings(clips), f32.get_scene_embeddings(clips)
    assert (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item() < 5e-2
