"""The fused residual-add + LayerNorm32 (``ops/layer_norm.py``): its plain
forward against the formula ``LayerNorm32`` has always computed, its plain
backward against autograd, the routes it counts, and, on a card, the kernels
against the plain versions.

The card's cases carry the ``card`` marker and skip without CUDA; run them
on the card with ``python -m pytest --noconftest tests/test_torch_layer_norm.py
-m card`` (the conftest imports JAX, which that machine does not have).
"""

import pytest
import torch

from wavjepa_tpu_torch.ops import layer_norm as L
from wavjepa_tpu_torch.ops.remat import remat
from wavjepa_tpu_torch.ops.transformer import LayerNorm32, TransformerEncoder
from wavjepa_tpu_torch.utils import profiling

WIDTHS = (384, 512, 768, 1024)


def inputs(d, dtype, seed, rows=(2, 7), device="cpu"):
    """x and a residual of shape (*rows, d), and f32 weight and bias away
    from 1 and 0 so that they take part in every product."""
    g = torch.Generator().manual_seed(seed)
    x = (3.0 * torch.randn(*rows, d, generator=g) + 0.5).to(dtype)
    r = torch.randn(*rows, d, generator=g).to(dtype)
    w = 1.0 + 0.3 * torch.randn(d, generator=g)
    b = 0.2 * torch.randn(d, generator=g)
    return (t.to(device) for t in (x, r, w, b))


def todays_formula(x, w, b, eps, dtype, residual=None):
    """``LayerNorm32.forward`` as it was written before the kernel, after
    the layer's ``x + residual``."""
    if residual is not None:
        x = x + residual
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(dtype)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_forward_is_todays_formula_bitwise(dtype, with_residual, eps, d):
    x, r, w, b = inputs(d, dtype, seed=d)
    r = r if with_residual else None
    out = L.layer_norm32_reference(x, w, b, eps, dtype, r)
    assert out.dtype == dtype
    assert torch.equal(out, todays_formula(x, w, b, eps, dtype, r))
    # the module and the routed entry take the plain version on the CPU
    ln = LayerNorm32(d, eps, dtype)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
        assert torch.equal(ln(x, r), out)


@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-5)])
def test_plain_backward_matches_autograd(dtype, tol, with_residual, d):
    x, r, w, b = inputs(d, dtype, seed=100 + d, rows=(3, 11))
    w, b = w.to(dtype), b.to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, r, w, b)]
    lx, lr, lw, lb = leaves
    y = L.layer_norm32_reference(lx, lw, lb, 1e-6, dtype, lr if with_residual else None)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(7), dtype=dtype)
    y.backward(dy)
    _, s, mean, rstd = L._reference_fwd(x, w, b, 1e-6, dtype, r if with_residual else None)
    ds, dw, db = L.layer_norm32_bwd_reference(dy, s, mean, rstd, w)
    torch.testing.assert_close(ds, lx.grad, atol=tol, rtol=tol)
    if with_residual:
        torch.testing.assert_close(ds, lr.grad, atol=tol, rtol=tol)
    torch.testing.assert_close(dw, lw.grad, atol=tol, rtol=tol)
    torch.testing.assert_close(db, lb.grad, atol=tol, rtol=tol)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_gradient_on_the_cpu(dtype, with_residual):
    """The module's gradient (through ``LayerNorm32Function``) against
    autograd through today's formula, and the same bits replayed under
    ``ops/remat.py``'s checkpoint; without a gradient it keeps nothing."""
    d = 384
    x, r, w, b = inputs(d, dtype, seed=3)
    ln = LayerNorm32(d, 1e-6, dtype)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)).to(dtype)

    def grads(fn):
        xx, rr = x.clone().requires_grad_(True), r.clone().requires_grad_(True)
        ln.zero_grad()
        fn(xx, rr if with_residual else None).backward(dy)
        return [xx.grad, rr.grad if with_residual else None, ln.weight.grad.clone(),
                ln.bias.grad.clone()]

    got = grads(ln)
    replayed = grads(lambda a, c: remat(ln, a, c))
    for g, h in zip(got, replayed):
        assert (g is None and h is None) or torch.equal(g, h)
    ref = grads(lambda a, c: todays_formula(a, ln.weight, ln.bias, 1e-6, dtype, c))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for g, h in zip(got, ref):
        if h is not None:
            torch.testing.assert_close(g.float(), h.float(), atol=tol, rtol=tol)
    xx = x.clone().requires_grad_(True)
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with ctx:
            y = ln(xx, r if with_residual else None)
        assert y.grad_fn is None
        assert torch.equal(y, L.layer_norm32_reference(x, w, b, 1e-6, dtype,
                                                       r if with_residual else None))


def test_cpu_calls_count_the_plain_route():
    x, r, w, b = inputs(384, torch.bfloat16, seed=1)
    ln = LayerNorm32(384, 1e-6, torch.bfloat16)
    with profiling.recording() as rec:
        ln(x, r)
    assert rec.counters == {"layer_norm.plain": 1}
    layers = 3
    enc = TransformerEncoder(layers, 32, 4, 64, dtype=torch.float32)
    enc.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 32)
    with profiling.recording() as rec:
        enc(x)
    assert rec.counters["layer_norm.plain"] == 2 * layers + 1
    assert rec.counters["layer_norm.kernel"] == 0
    before = (L.layer_norm32_fwd.launches, L.layer_norm32_bwd.launches)
    x.requires_grad_(True)
    enc(x).sum().backward()
    assert (L.layer_norm32_fwd.launches, L.layer_norm32_bwd.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    x, r, w, b = inputs(384, torch.bfloat16, seed=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        L.layer_norm32_fwd(x, w, b, 1e-6, torch.bfloat16, r)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("d", (*WIDTHS, 200))
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_the_plain_versions(card, dtype, with_residual, d):
    x, r, w, b = inputs(d, dtype, seed=d, rows=(64, 88), device=card)
    r = r if with_residual else None
    y, s, mean, rstd = L.layer_norm32_fwd(x, w, b, 1e-6, dtype, r, save=True)
    y_ref, s_ref, mean_ref, rstd_ref = L._reference_fwd(x, w, b, 1e-6, dtype, r)
    assert torch.equal(s, s_ref)  # the add rounds as the plain add does
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, atol=1e-5, rtol=1e-5)
    # bf16: one ulp where the f32 values straddle a rounding point
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    dy = torch.randn(y.shape, device=card).to(dtype)
    ds, dw, db = L.layer_norm32_bwd(dy, s, mean, rstd, w)
    ds_ref, dw_ref, db_ref = L.layer_norm32_bwd_reference(dy, s, mean, rstd, w)
    torch.testing.assert_close(ds.float(), ds_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dw, dw_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, db_ref, atol=1e-3, rtol=1e-4)
    again = L.layer_norm32_bwd(dy, s, mean, rstd, w)
    assert all(torch.equal(u, v) for u, v in zip((ds, dw, db), again))
