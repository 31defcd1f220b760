"""The port's JEPA encoder side against the JAX package's JEPA: weights from
``JEPA(cfg).init`` carried across with ``state_dict_from_jax_params``, the
same numpy audio on both sides. Whole model in f32: atol 5e-5, rtol 1e-4 —
the op tolerance of 2e-5 loosened because the error of two post-norm layers
on top of the conv frontend, LayerNorms and mapper compounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api.convert import export_jepa_state_dict
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.models.jepa import jepa_config_to_dict as jax_config_to_dict
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.models.jepa import (
    JEPA,
    JEPAConfig,
    jepa_config_from_dict,
    jepa_config_to_dict,
)

ATOL, RTOL = 5e-5, 1e-4
TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
)


def _pair(mode="default", **kw):
    jc = JaxConfig(**TINY, extractor_mode=mode, **kw)
    tc = JEPAConfig(**TINY, extractor_mode=mode, **kw)
    rng = np.random.default_rng(7)
    audio = rng.standard_normal((3, 1, jc.target_length)).astype(np.float32)
    params = JaxJEPA(jc).init(jax.random.PRNGKey(0), jnp.asarray(audio))["params"]
    params = jax.tree.map(np.asarray, params)
    port = JEPA(tc)
    port.load_state_dict(state_dict_from_jax_params(params, extractor_mode=mode))
    return JaxJEPA(jc), params, port, audio


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_encode_features_matches_jax(mode):
    jm, params, port, audio = _pair(mode)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(audio), method="encode_features"))
    out = port.encode_features(torch.from_numpy(audio)).detach().numpy()
    assert out.shape == (3, port.config.total_patches, 32)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_represent_matches_jax(masked):
    jm, params, port, audio = _pair()
    t = port.config.total_patches
    mask = np.zeros((3, t), bool)
    mask[0, t // 2:] = True  # padded tail
    mask[1] = True           # a fully padded window
    jmask = jnp.asarray(mask) if masked else None
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(audio), jmask, method="represent"))
    out = port.represent(
        torch.from_numpy(audio), torch.from_numpy(mask) if masked else None
    ).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_state_dict_names_are_the_reference_names():
    _, params, port, _ = _pair()
    sd = state_dict_from_jax_params(params)
    assert set(sd) == set(port.state_dict())
    assert "extract_audio.cnn.0.2.weight" in sd
    assert "encoder.layers.1.self_attn.in_proj_weight" in sd
    # the training side is carried too, under the names the JAX export writes
    jax_names = set(export_jepa_state_dict(params))
    assert set(sd) == jax_names
    assert {"decoder.layers.0.linear1.weight", "encoder_to_decoder_mapper.weight",
            "decoder_to_encoder_mapper.bias", "mask_token"} <= jax_names
    assert tuple(sd["mask_token"].shape) == (1, 1, 16)


def test_config_rewrites_and_roundtrip():
    for size in ("base", "large", "tiny"):
        jc, tc = JaxConfig(size=size), JEPAConfig(size=size)
        for f in ("encoder_layers", "encoder_dim", "encoder_heads", "decoder_dim",
                  "target_length", "frames_per_window", "total_patches", "embedding_dim"):
            assert getattr(tc, f) == getattr(jc, f), (size, f)
    assert JEPAConfig(process_seconds=10.0).total_patches == 999
    tc = JEPAConfig(dtype=torch.bfloat16, size="large", pack_encoder=96)
    d = jepa_config_to_dict(tc)
    assert d == jax_config_to_dict(JaxConfig(dtype=jnp.bfloat16, size="large", pack_encoder=96))
    assert jepa_config_from_dict(d) == tc
    assert jepa_config_from_dict({**d, "newer_field": 1}) == tc


def test_seeded_init_is_reproducible_and_finite():
    cfg = dataclasses.replace(JEPAConfig(**TINY))
    a, b = JEPA(cfg), JEPA(cfg)
    a.init_parameters(torch.Generator().manual_seed(3))
    b.init_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, cfg.target_length)).astype(np.float32))
    out = a.represent(audio)
    assert out.shape == (2, cfg.total_patches, cfg.encoder_dim)
    assert torch.isfinite(out).all()
