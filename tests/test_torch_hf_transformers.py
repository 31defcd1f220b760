"""transformers-native loading of the port (``api/hf_transformers.py``): the
three tests of tests/test_hf_transformers.py on the port, registered and
``trust_remote_code``, against the port's runtime and the JAX runtime; a
directory the JAX package exported, loaded by the port's class; the CLI; and
the copied modeling file's imports. f32 across packages: atol 5e-5, rtol 1e-4
(as tests/test_torch_runtime.py)."""

import ast
import dataclasses
import os
import shutil

# transformers imports TensorFlow where it is installed; nothing here needs it
os.environ.setdefault("USE_TF", "0")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file
from transformers import AutoConfig, AutoFeatureExtractor, AutoModel

from wavjepa_tpu.api import hf_transformers as jhft
from wavjepa_tpu.api import runtime as jrt
from wavjepa_tpu.api.convert import convert_jepa_state_dict
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu_torch.api import hf_transformers as thft
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig

ATOL, RTOL = 5e-5, 1e-4
TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2,
)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wavjepa_tpu")


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One set of JAX params, exported by each package, and both runtimes."""
    jc = JaxConfig(**TINY)
    params = jax.tree.map(np.asarray, jax.jit(JaxJEPA(jc).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))["params"])
    runtime = trt.RuntimeJEPA(JEPAConfig(**TINY), state_dict_from_jax_params(params),
                              device="cpu")
    root = tmp_path_factory.mktemp("hf_export")
    port_dir = thft.export_transformers_pretrained(root / "port", runtime)
    jax_dir = root / "jax"
    jhft.export_transformers_pretrained(jax_dir, jc, params)
    return port_dir, jax_dir, runtime, jrt.RuntimeJEPA(jc, params)


def _clip(channels=1):
    rng = np.random.default_rng(3)
    return 0.2 * rng.standard_normal((1, 1600 * 2) if channels == 1 else
                                     (1, channels, 1600 * 2)).astype(np.float32)


def test_automodel_from_pretrained_matches_runtime(exports):
    port_dir, _, runtime, jax_runtime = exports
    model = AutoModel.from_pretrained(port_dir, device="cpu")
    fx = AutoFeatureExtractor.from_pretrained(port_dir)
    assert isinstance(model, thft.WavJEPATransformersModel)
    assert isinstance(fx, thft.WavJEPATorchFeatureExtractor)
    assert next(model.parameters()).device.type == "cpu" and not model.training

    inputs = fx(_clip())
    emb, ts = model(inputs["input_values"])
    ref_emb, ref_ts = runtime.get_timestamp_embeddings(inputs["input_values"])
    assert torch.equal(emb, ref_emb) and torch.equal(ts, ref_ts)
    jax_emb, jax_ts = jax_runtime.get_timestamp_embeddings(inputs["input_values"])
    np.testing.assert_allclose(emb.numpy(), jax_emb, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), jax_ts, rtol=1e-12)
    # return_tensors gives the same values as torch, from the runtime the
    # first call built
    runtime_built = model._runtime
    pt = fx(_clip(), return_tensors="pt")["input_values"]
    assert torch.equal(model(pt)[0], emb)
    assert model._runtime is runtime_built


def test_trust_remote_code_path(exports):
    port_dir, _, runtime, jax_runtime = exports
    model = AutoModel.from_pretrained(port_dir, trust_remote_code=True, device="cpu")
    # the directory's own copy of the module, not this package's class
    assert type(model).__module__.startswith("transformers_modules")
    emb, _ = model(_clip())
    assert torch.equal(emb, runtime.get_timestamp_embeddings(_clip())[0])
    np.testing.assert_allclose(emb.numpy(), jax_runtime.get_timestamp_embeddings(_clip())[0],
                               atol=ATOL, rtol=RTOL)


def test_weights_actually_load(exports):
    """from_pretrained must fill the reference-layout parameters (a freshly
    built model differs), and the safetensors file imports as a reference
    checkpoint."""
    port_dir, *_ = exports
    cfg = AutoConfig.from_pretrained(port_dir)
    assert cfg.model_type == "wavjepa_tpu_torch"
    loaded = AutoModel.from_pretrained(port_dir, device="cpu")
    fresh = thft.WavJEPATransformersModel(cfg)
    sd = loaded.state_dict()
    key = "encoder.layers.0.self_attn.in_proj_weight"
    assert key in sd and float(sd[key].abs().sum()) > 0
    assert not torch.equal(sd[key], fresh.state_dict()[key])
    assert set(load_file(port_dir / "model.safetensors")) == set(sd)
    params, _ = convert_jepa_state_dict(
        {k: v.numpy() for k, v in sd.items()}, encoder_layers=cfg.encoder_layers,
        decoder_layers=cfg.decoder_layers, conv_layers=len(cfg.conv_spec), with_decoder=False)
    assert "encoder" in params and "extract_audio" in params


def test_the_port_loads_a_jax_package_export(exports):
    _, jax_dir, _, jax_runtime = exports
    # both packages registered in one process, each under its own model_type
    assert type(AutoModel.from_pretrained(jax_dir)) is jhft.WavJEPATransformersModel
    model = thft.WavJEPATransformersModel.from_pretrained(jax_dir, device="cpu")
    emb, ts = model(_clip())
    ref_emb, ref_ts = jax_runtime.get_timestamp_embeddings(_clip())
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), ref_ts, rtol=1e-12)
    # the decoder and the stored tables were there, and were dropped by name
    stored = set(load_file(jax_dir / "model.safetensors"))
    assert {"mask_token", "pos_encoding_encoder", "decoder.norm.weight"} <= stored
    assert set(model.state_dict()) < stored


@pytest.mark.parametrize("fault", ["extra_encoder_key", "missing_key", "wrong_shape"])
def test_a_jax_export_that_does_not_fit_raises(exports, tmp_path, fault):
    _, jax_dir, *_ = exports
    bad = tmp_path / "bad"
    shutil.copytree(jax_dir, bad)
    sd = load_file(bad / "model.safetensors")
    if fault == "extra_encoder_key":
        sd["encoder.layers.2.norm1.weight"] = torch.ones(32)
    elif fault == "missing_key":
        del sd["feature_norms.weight"]
    else:
        sd["feature_norms.weight"] = torch.ones(17)
    save_file(sd, bad / "model.safetensors", metadata={"format": "pt"})
    with pytest.raises((KeyError, RuntimeError)):
        thft.WavJEPATransformersModel.from_pretrained(bad, device="cpu")


def test_cli_exports_a_checkpoint(tmp_path, capsys):
    cfg = JEPAConfig(size="tiny")
    model = JEPA(cfg)
    model.init_parameters(torch.Generator().manual_seed(5))
    ckpt = tmp_path / "model.ckpt"
    torch.save({"state_dict": model.state_dict(), "epoch": 1}, ckpt)
    assert thft._main([str(ckpt), str(tmp_path / "out"), "--size", "tiny"]) == 0
    assert "exported transformers dir" in capsys.readouterr().out
    hf_model = AutoModel.from_pretrained(tmp_path / "out", device="cpu")
    served = trt.load_model(str(ckpt), model_size="tiny", device="cpu")
    f32 = trt.RuntimeJEPA(dataclasses.replace(served.config, dtype=torch.float32),
                          served.model.state_dict(), device="cpu")
    audio = np.random.default_rng(2).standard_normal((1, 20000)).astype(np.float32)
    assert torch.equal(hf_model(audio)[0], f32.get_timestamp_embeddings(audio)[0])


def test_the_copied_modeling_file_imports_no_jax(exports):
    port_dir, *_ = exports
    tree = ast.parse((port_dir / "modeling_wavjepa_tpu_torch.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "wavjepa_tpu_torch" in roots and not roots & set(FORBIDDEN), roots
