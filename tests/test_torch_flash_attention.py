"""The port's attention against the JAX package's: the plain twin of the
Hopper kernel against the Pallas kernel in interpret mode, and the wrapper's
routing of CPU tensors. f32 throughout; tolerance atol 2e-5, rtol 1e-4, as in
tests/test_flash_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from wavjepa_tpu.ops.transformer import dot_product_attention as jax_dpa
from wavjepa_tpu.ops.transformer import key_padding_bias as jax_kpb
from wavjepa_tpu_torch.ops import flash_attention as fa_mod
from wavjepa_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)
from wavjepa_tpu_torch.ops.transformer import dot_product_attention, key_padding_bias

ATOL, RTOL = 2e-5, 1e-4


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, t)) < 0.3
    mask[0] = True    # fully masked row
    mask[-1] = False  # clean row
    return q, k, v, mask


@pytest.mark.parametrize("head_dim", [32, 64])
def test_reference_matches_pallas_interpret(head_dim):
    # T=70 is not a multiple of the kernel's 64-key tile
    q, k, v, mask = _inputs(head_dim, 3, 2, 70, head_dim)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, mask)), True))
    out = flash_attention_reference(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # the fully masked row is the mean of v over the real keys, not NaN
    np.testing.assert_allclose(
        out[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True), v[0].shape),
        atol=ATOL, rtol=RTOL,
    )


def test_cpu_wrapper_routes_to_reference_without_counting():
    q, k, v, mask = map(torch.from_numpy, _inputs(3, 2, 3, 40, 32))
    before = flash_attention_fwd.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention_fwd.launches == before  # the count is of kernel launches
    torch.testing.assert_close(out, flash_attention_reference(q, k, v, mask), atol=0, rtol=0)


def test_cpu_wrapper_never_builds_the_kernel(monkeypatch):
    def fail(*_):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(fa_mod._build, "load", fail)
    q, k, v, mask = map(torch.from_numpy, _inputs(4, 1, 2, 16, 64))
    flash_attention(q, k, v, mask)


def test_wrapper_rejects_bad_inputs():
    q, k, v, mask = map(torch.from_numpy, _inputs(5, 2, 2, 16, 32))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :8], v, mask)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask.int().bool()[:, :8])
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), v, mask)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_eager_attention_matches_jax_einsum(head_dim):
    q, k, v, mask = _inputs(10 + head_dim, 2, 3, 50, head_dim)
    ref = np.asarray(jax_dpa(*map(jnp.asarray, (q, k, v)), bias=jax_kpb(jnp.asarray(mask))))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    out = dot_product_attention(tq, tk, tv, bias=key_padding_bias(tm)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # the einsum semantics and the kernel's agree in f32
    np.testing.assert_allclose(
        out, flash_attention_reference(tq, tk, tv, tm).numpy(), atol=ATOL, rtol=RTOL
    )
