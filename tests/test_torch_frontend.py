"""The port's conv frontend and position tables against the JAX package's.
Same numpy inputs and weights on both sides; f32, atol 2e-5, rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops import conv_frontend as jcf
from wavjepa_tpu.ops import pos_embed as jpe
from wavjepa_tpu_torch.models.jepa import JEPAConfig
from wavjepa_tpu_torch.ops import conv_frontend as tcf
from wavjepa_tpu_torch.ops import pos_embed as tpe

ATOL, RTOL = 2e-5, 1e-4
SPEC = ((16, 10, 5), (16, 3, 2), (8, 2, 2))


def _port_state(params, mode):
    out = {}
    for name, block in params.items():
        i = int(name.split("_")[1])
        out[f"cnn.{i}.0.weight"] = torch.tensor(np.asarray(block["kernel"]))
        if "norm_scale" in block:
            norm = f"cnn.{i}.2.1" if mode == "layer_norm" else f"cnn.{i}.2"
            out[f"{norm}.weight"] = torch.tensor(np.asarray(block["norm_scale"]))
            out[f"{norm}.bias"] = torch.tensor(np.asarray(block["norm_bias"]))
    return out


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
@pytest.mark.parametrize("in_channels", [1, 2])
def test_conv_frontend_matches_jax(mode, in_channels):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, in_channels, 400)).astype(np.float32)
    jmod = jcf.ConvFeatureExtractor(conv_spec=SPEC, in_channels=in_channels, mode=mode)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # non-trivial norm affine, so a misplaced scale or bias shows
    params = jax.tree.map(np.asarray, params)
    for block in params.values():
        if "norm_scale" in block:
            block["norm_scale"] = rng.uniform(0.5, 1.5, block["norm_scale"].shape).astype(np.float32)
            block["norm_bias"] = rng.standard_normal(block["norm_bias"].shape).astype(np.float32)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    port = tcf.ConvFeatureExtractor(SPEC, in_channels=in_channels, mode=mode)
    port.load_state_dict(_port_state(params, mode))
    out = port(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape == (3, tcf.conv_output_length(400, SPEC), 8)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_conv_block_names_follow_reference():
    names = set(tcf.ConvFeatureExtractor(SPEC).state_dict())
    assert names == {"cnn.0.0.weight", "cnn.0.2.weight", "cnn.0.2.bias",
                     "cnn.1.0.weight", "cnn.2.0.weight"}
    names = set(tcf.ConvFeatureExtractor(SPEC, mode="layer_norm").state_dict())
    assert "cnn.2.2.1.weight" in names and "cnn.0.2.1.bias" in names


@pytest.mark.parametrize("spec", [tcf.WAVJEPA_CONV_SPEC, tcf.WAV2VEC2_CONV_SPEC, SPEC])
def test_conv_shape_helpers_match_jax(spec):
    for t in (400, 32159, 160000):
        assert tcf.conv_output_length(t, spec) == jcf.conv_output_length(t, spec)
    assert tcf.conv_receptive_fields(spec) == jcf.conv_receptive_fields(spec)
    with pytest.raises(ValueError):
        tcf.conv_output_length(5, spec)


def test_position_tables_match_exactly():
    for dim, n in ((768, 200), (32, 999), (1024, 200)):
        np.testing.assert_array_equal(
            tpe.get_1d_sincos_pos_embed(dim, n), jpe.get_1d_sincos_pos_embed(dim, n)
        )
        np.testing.assert_array_equal(
            tpe.get_binaural_pos_embed(dim, n), jpe.get_binaural_pos_embed(dim, n)
        )
    for kw in ({}, {"process_seconds": 10.0}, {"size": "large"}):
        tc, jc = JEPAConfig(**kw), JaxConfig(**kw)
        for dim in (tc.encoder_dim, 384):
            table = tc.pos_table(dim)
            assert table.dtype == np.float32
            np.testing.assert_array_equal(table, jc.pos_table(dim))
    tc, jc = JEPAConfig(pos_embed="binaural"), JaxConfig(pos_embed="binaural")
    np.testing.assert_array_equal(tc.pos_table(64), jc.pos_table(64))
