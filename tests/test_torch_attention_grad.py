"""The port's attention gradient against ``jax.grad`` of the JAX package's
``flash_attention`` (its custom VJP, ``_bwd_kernel`` run in interpret mode).

A fully masked row has uniform weights, so its dS = P⊙(dP − rowsum(dP⊙P))
is not zero and dq, dk get its share; autograd through the plain forward's
``masked_fill`` would zero it. f32 throughout: atol 5e-5, rtol 1e-3, the
gradient tolerance the roadmap sets for this kernel (sums over T keys in
another order than the interpreter's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from wavjepa_tpu_torch.ops import flash_attention as fa_mod
from wavjepa_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
)

ATOL, RTOL = 5e-5, 1e-3


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    mask = rng.random((b, t)) < 0.3
    mask[0] = True    # fully masked row
    mask[-1] = False  # clean row
    return q, k, v, mask, do


def _jax_grads(q, k, v, mask, do):
    m = jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, m, True) * do)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


# T=70 is not a multiple of the kernel's 64-row tiles
@pytest.mark.parametrize("head_dim", [32, 64])
def test_bwd_reference_matches_jax_grad(head_dim):
    q, k, v, mask, do = _inputs(head_dim, 3, 2, 70, head_dim)
    ref = _jax_grads(q, k, v, mask, do)
    out = flash_attention_bwd_reference(*map(torch.from_numpy, (q, k, v, mask, do)))
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_autograd_through_flash_attention_matches_jax_grad(head_dim):
    q, k, v, mask, do = _inputs(100 + head_dim, 2, 3, 70, head_dim)
    ref = _jax_grads(q, k, v, mask, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=ATOL, rtol=RTOL, err_msg=name)


def test_fully_masked_row_gets_a_gradient():
    # the row whose keys are all masked: uniform P, so dq is not zero there
    q, k, v, mask, do = _inputs(5, 2, 2, 24, 32)
    ref_dq = _jax_grads(q, k, v, mask, do)[0]
    tq = torch.from_numpy(q).requires_grad_(True)
    flash_attention(tq, *map(torch.from_numpy, (k, v, mask))).backward(torch.from_numpy(do))
    assert np.abs(ref_dq[0]).max() > 0.1
    np.testing.assert_allclose(tq.grad.numpy()[0], ref_dq[0], atol=ATOL, rtol=RTOL)


def test_no_gradient_wanted_builds_no_graph():
    q, k, v, mask, _ = map(torch.from_numpy, _inputs(6, 1, 2, 16, 32))
    assert flash_attention(q, k, v, mask).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(q, k, v, mask).grad_fn is None
    assert flash_attention(q, k, v, mask).grad_fn is not None


def test_bf16_reference_rounds_like_the_kernel():
    # bf16 inputs: the plain backward rounds P and dS to bf16 before their
    # products and returns bf16, within a bf16 ulp of the f32 maths
    q, k, v, mask, do = map(torch.from_numpy, _inputs(7, 2, 2, 40, 64))
    lo = flash_attention_bwd_reference(*(x.bfloat16() if x.is_floating_point() else x
                                         for x in (q, k, v, mask, do)))
    hi = flash_attention_bwd_reference(q, k, v, mask, do)
    for a, b in zip(lo, hi):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, atol=0.1, rtol=0.05)


def test_kernel_wrappers_are_for_cuda_tensors_only(monkeypatch):
    def fail(*_):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(fa_mod._build, "load", fail)
    q, k, v, mask, do = map(torch.from_numpy, _inputs(8, 1, 2, 16, 32))
    stats = torch.zeros(1, 2, 16, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(q, k, v, mask, do, stats)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa_mod.flash_attention_fwd(q, k, v, mask, with_stats=True)
    with pytest.raises(ValueError, match="stats"):
        flash_attention_bwd(q, k, v, mask, do, stats[..., :1])
    before = flash_attention_bwd.launches
    tq = q.clone().requires_grad_(True)
    flash_attention(tq, k, v, mask).sum().backward()
    assert flash_attention_bwd.launches == before
