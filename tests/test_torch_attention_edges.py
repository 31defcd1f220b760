"""The plain versions of the port's attention kernels against the JAX
package's Pallas kernel (interpret mode) at every sequence length where the
Hopper kernels change tile or route: one key or query tile of 64 and its
edges (1, 8, 63, 64, 65), the training shapes (88 packed encoder, 100
ragged, 128 packed decoder, the backward's largest one-pass T), the first T
of the two-pass backward (129), the windowed encoder (200) and WavJEPA-Nat's
packed encoder and decoder (176, 256), both on the two-pass route; head_dim
32 and 64. Each batch has a fully masked first row and a clean last row. The
tolerances are those of tests/test_flash_attention.py (forward, f32: atol
2e-5, rtol 1e-4) and of the roadmap's gradient contract (atol 5e-5, rtol
1e-3): the same maths, summed over T keys in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from wavjepa_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_reference,
)

EDGE_T = [1, 8, 63, 64, 65, 88, 100, 128, 129, 176, 200, 256]
HEAD_DIMS = [32, 64]
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
BWD_ATOL, BWD_RTOL = 5e-5, 1e-3


def _inputs(seed, t, d, b=2, h=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    mask = rng.random((b, t)) < 0.3
    mask[0] = True    # fully masked row
    mask[-1] = False  # clean row
    return q, k, v, mask, do


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("t", EDGE_T)
def test_forward_reference_matches_pallas_at_tile_edges(t, head_dim):
    q, k, v, mask, _ = _inputs(1000 + t + head_dim, t, head_dim)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, mask)), True))
    out = flash_attention_reference(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL, rtol=FWD_RTOL)
    # the fully masked row is the mean of v over the real keys
    np.testing.assert_allclose(
        out[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True), v[0].shape),
        atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("t", EDGE_T)
def test_backward_reference_matches_pallas_grad_at_route_edges(t, head_dim):
    q, k, v, mask, do = _inputs(2000 + t + head_dim, t, head_dim)
    m = jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, m, True) * do)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out = flash_attention_bwd_reference(*map(torch.from_numpy, (q, k, v, mask, do)))
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=name)
    # the fully masked row keeps its dS: its dq is not zero (at T = 1 the
    # one key has P = 1, so dS = P·(dP − P·dP) is zero on every row)
    if t > 1:
        assert np.abs(np.asarray(ref[0])[0]).max() > 0
        assert np.abs(out[0][0].numpy()).max() > 0
