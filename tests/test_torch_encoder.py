"""The port's post-norm TransformerEncoder against the JAX package's, with a
key-padding mask that includes a fully masked row. f32, atol 2e-5, rtol 1e-4
(the JAX side runs its einsum path; the port runs the kernel's plain twin,
whose f32 semantics agree, see test_torch_flash_attention.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.ops.transformer import TransformerEncoder as JaxEncoder
from wavjepa_tpu_torch.ops.transformer import (
    LayerNorm32,
    TransformerEncoder,
    check_attn_impl,
)

ATOL, RTOL = 2e-5, 1e-4
LAYERS, DIM, HEADS, MLP, T = 2, 32, 4, 128, 37


def _port_state(params):
    t = lambda a: torch.tensor(np.asarray(a))
    out = {}
    for i in range(LAYERS):
        lp, p = f"layers.{i}", params[f"layers_{i}"]
        out[f"{lp}.self_attn.in_proj_weight"] = t(p["self_attn"]["in_proj"]["kernel"]).T
        out[f"{lp}.self_attn.in_proj_bias"] = t(p["self_attn"]["in_proj"]["bias"])
        for name, sub in (("self_attn.out_proj", p["self_attn"]["out_proj"]),
                          ("linear1", p["linear1"]), ("linear2", p["linear2"])):
            out[f"{lp}.{name}.weight"] = t(sub["kernel"]).T
            out[f"{lp}.{name}.bias"] = t(sub["bias"])
        for name in ("norm1", "norm2"):
            out[f"{lp}.{name}.weight"] = t(p[name]["scale"])
            out[f"{lp}.{name}.bias"] = t(p[name]["bias"])
    out["norm.weight"] = t(params["norm"]["scale"])
    out["norm.bias"] = t(params["norm"]["bias"])
    return out


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, T, DIM)).astype(np.float32)
    mask = rng.random((3, T)) < 0.3
    mask[1] = True
    mask[2] = False
    jenc = JaxEncoder(num_layers=LAYERS, embed_dim=DIM, num_heads=HEADS, mlp_dim=MLP)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    # non-trivial biases and norm affines, so a misplaced one shows
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    port = TransformerEncoder(LAYERS, DIM, HEADS, MLP)
    port.load_state_dict(_port_state(params))
    return jenc, params, port, x, mask


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_jax(pair, masked):
    jenc, params, port, x, mask = pair
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(x), jm))
    out = port(torch.from_numpy(x), tm).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_layer_outputs_match_jax(pair):
    jenc, params, port, x, mask = pair
    refs = jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                      method="layer_outputs")
    outs = port.layer_outputs(torch.from_numpy(x), torch.from_numpy(mask))
    assert len(outs) == len(refs) == LAYERS
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_layernorm32_runs_f32_and_returns_compute_dtype():
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    ln = LayerNorm32(16, eps=1e-6, dtype=torch.bfloat16)
    y = ln(x)
    assert y.dtype == torch.bfloat16
    x32 = x.float()
    ref = (x32 - x32.mean(-1, keepdim=True)) / torch.sqrt(x32.var(-1, unbiased=False, keepdim=True) + 1e-6)
    torch.testing.assert_close(y, ref.bfloat16(), atol=0, rtol=0)


def test_attn_impl_choices():
    for impl in ("auto", "einsum", "einsum_bthd", "sdpa", "pallas", "fused_block"):
        assert check_attn_impl(impl) == impl
    with pytest.raises(ValueError):
        check_attn_impl("xla")
