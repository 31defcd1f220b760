"""The port's projection-fused attention block against the JAX package's
Pallas kernel, run in interpret mode: the weight packing, the forward (the
plain version of ``_fwd_kernel``) and the gradients of
``FusedAttentionBlock`` on the CPU (``_bwd_kernel``'s maths, carried back to
the torch parameters through ``pack_weights``), each on numpy inputs made
from one seed and handed to both packages.

Tolerances are those of tests/test_fused_attention_block.py: forward atol
and rtol 2e-5, gradients 5e-5 (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.ops.fused_attention_block import fused_attention_block as jax_block
from wavjepa_tpu.ops.fused_attention_block import pack_weights as jax_pack
from wavjepa_tpu_torch.ops import fused_attention_block as fab

FWD_TOL, GRAD_TOL = 2e-5, 5e-5


def _case(b, t, d, heads, seed, masked_row=True):
    """Flax-layout weights ((D, 3D) in_proj kernel, (D, D) out kernel), x, a
    mask with a fully masked first row (when asked) and a loss weight."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, ipk, ipb, opk, opb = f(b, t, d) * 0.3, f(d, 3 * d) * 0.1, f(3 * d) * 0.1, f(d, d) * 0.1, f(d) * 0.1
    mask = rng.random((b, t)) < 0.3
    if masked_row:
        mask[0] = True
    return x, ipk, ipb, opk, opb, mask, f(b, t, d)


def _torch_params(ipk, ipb, opk):
    """The port's parameters of the same weights: in_proj_weight (3D, D),
    in_proj_bias, out_proj.weight (D, D), with gradients wanted."""
    return [torch.tensor(a).requires_grad_(True) for a in (ipk.T.copy(), ipb, opk.T.copy())]


def _jax_out(x, ipk, ipb, opk, opb, mask, heads):
    wqkv, bqkv, wo = jax_pack(jnp.asarray(ipk), jnp.asarray(ipb), jnp.asarray(opk), heads)
    return jax_block(jnp.asarray(x), wqkv, bqkv, wo, jnp.asarray(opb)[None], jnp.asarray(mask), True)


def test_pack_weights_matches_jax():
    _, ipk, ipb, opk, *_ = _case(1, 4, 48, 3, seed=0)
    ref = jax_pack(jnp.asarray(ipk), jnp.asarray(ipb), jnp.asarray(opk), 3)
    got = fab.pack_weights(*(p.detach() for p in _torch_params(ipk, ipb, opk)), 3)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# tests/test_fused_attention_block.py's shapes, then head_dim 32 with a fully
# masked row
@pytest.mark.parametrize("b,t,d,heads,masked_row", [
    (3, 16, 32, 4, False), (2, 24, 48, 3, False), (2, 20, 64, 2, True),
])
def test_forward_matches_jax(b, t, d, heads, masked_row):
    x, ipk, ipb, opk, opb, mask, _ = _case(b, t, d, heads, seed=1, masked_row=masked_row)
    ref = np.asarray(_jax_out(x, ipk, ipb, opk, opb, mask, heads))
    w, bias, wout = (p.detach() for p in _torch_params(ipk, ipb, opk))
    got = fab.fused_attention_block(torch.tensor(x), *fab.pack_weights(w, bias, wout, heads),
                                    torch.tensor(opb)[None], torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=FWD_TOL, atol=FWD_TOL)


def _port_grads(x, ipk, ipb, opk, opb, mask, wl, heads, block=fab.fused_attention_block):
    """Gradients of sum(wl · block) in the port, on the torch parameters."""
    tx = torch.tensor(x, requires_grad=True)
    w, bias, wout = _torch_params(ipk, ipb, opk)
    tb = torch.tensor(opb).requires_grad_(True)
    out = block(tx, *fab.pack_weights(w, bias, wout, heads), tb[None], torch.tensor(mask))
    (out * torch.tensor(wl)).sum().backward()
    return [tx.grad.numpy(), w.grad.numpy().T, bias.grad.numpy(), wout.grad.numpy().T,
            tb.grad.numpy()]


@pytest.mark.parametrize("b,t,d,heads", [(2, 16, 32, 4), (3, 20, 64, 2)])
def test_gradients_match_jax(b, t, d, heads):
    # the first row's keys are all masked: uniform P, and a dS that is not 0
    x, ipk, ipb, opk, opb, mask, wl = _case(b, t, d, heads, seed=2)

    def loss(*args):
        return jnp.sum(jnp.asarray(wl) * _jax_out(*args, mask, heads))

    refs = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, ipk, ipb, opk, opb)))
    got = _port_grads(x, ipk, ipb, opk, opb, mask, wl, heads)
    for name, r, g in zip(("dx", "d_in_proj_k", "d_in_proj_b", "d_out_proj_k", "d_out_proj_b"),
                          refs, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_autograd_through_the_plain_forward_differs_on_a_fully_masked_row():
    # masked_fill zeroes dS at masked keys; the TPU backward keeps it for a
    # row whose keys are all masked, so dx of that row differs
    b, t, d, heads = 2, 16, 32, 4
    case = _case(b, t, d, heads, seed=3)
    explicit = _port_grads(*case, heads)
    plain = _port_grads(*case, heads, block=fab.fused_attention_block_reference)
    np.testing.assert_allclose(plain[0][1], explicit[0][1], rtol=GRAD_TOL, atol=GRAD_TOL)
    assert np.abs(plain[0][0] - explicit[0][0]).max() > 1e-2


def test_bf16_call_returns_bf16_weight_gradients():
    b, t, d, heads = 2, 8, 32, 4
    x, ipk, ipb, opk, opb, mask, wl = _case(b, t, d, heads, seed=4)
    w = [torch.tensor(a).bfloat16().requires_grad_(True)
         for a in (x, *(np.asarray(a) for a in jax_pack(ipk, ipb, opk, heads)), opb[None])]
    out = fab.fused_attention_block(*w, torch.tensor(mask))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.tensor(wl)).sum().backward()
    assert all(a.grad.dtype == torch.bfloat16 and a.grad.shape == a.shape for a in w)
    assert all(torch.isfinite(a.grad.float()).all() for a in w)


def test_kernel_wrappers_take_no_cpu_tensors():
    x, ipk, ipb, opk, opb, mask, wl = _case(1, 8, 64, 2, seed=5)
    w_in, b_in, w_out = (p.detach() for p in _torch_params(ipk, ipb, opk))
    tx, tm = torch.tensor(x), torch.tensor(mask)
    with pytest.raises(ValueError, match="cuda"):
        fab.fused_attention_block_fwd(tx, w_in, b_in, w_out, torch.tensor(opb), tm, 2)
    with pytest.raises(ValueError, match="cuda"):
        fab.fused_attention_block_bwd(tx, w_in, b_in, w_out, tm, torch.tensor(wl), 2)
    assert fab.fused_attention_block_fwd.launches == fab.fused_attention_block_bwd.launches == 0


def test_checks_refuse_mismatched_inputs():
    x, ipk, ipb, opk, opb, mask, _ = _case(1, 8, 32, 4, seed=6)
    wqkv, bqkv, wo = (torch.tensor(np.asarray(a)) for a in jax_pack(ipk, ipb, opk, 4))
    tx, tb, tm = torch.tensor(x), torch.tensor(opb)[None], torch.tensor(mask)
    with pytest.raises(ValueError, match="mask"):
        fab.fused_attention_block(tx, wqkv, bqkv, wo, tb, tm[:, :4])
    with pytest.raises(ValueError, match="bqkv"):
        fab.fused_attention_block(tx, wqkv, bqkv[:, :, :3], wo, tb, tm)
    with pytest.raises(TypeError, match="dtype"):
        fab.fused_attention_block(tx.bfloat16(), wqkv, bqkv, wo, tb, tm)


@pytest.mark.parametrize("rows", [64 * 128, 1024 * 128, 16 * 88, 100])
def test_weight_gradient_partials_do_not_scale_with_the_batch(rows):
    for d in (384, 768, 1024):
        for t in fab.weight_grad_tiles(d):  # the kernel's 128 × 128 tiles
            s = fab.weight_grad_splits(rows, t, sms=132)  # an H100 SXM
            assert 1 <= s <= 16 and (s == 1 or rows // s >= 256)


def test_weight_gradient_tiles_are_the_kernels_128_by_128_tiles():
    assert fab.weight_grad_tiles(384) == (27, 9)
    assert fab.weight_grad_tiles(768) == (108, 36)
    assert fab.weight_grad_tiles(1024) == (192, 64)
    assert fab.weight_grad_tiles(96) == (3, 1)  # one ragged tile a side


@pytest.mark.parametrize("d", [384, 768, 1024])
def test_weight_gradient_splits_stop_growing_at_a_large_batch(d):
    # past 16 chunks of 256 rows the count is fixed: the partials, at most
    # 16·(3D² + 3D) floats, are the same at the microbatch and the full batch
    for t in fab.weight_grad_tiles(d):
        counts = {fab.weight_grad_splits(rows, t, sms=132) for rows in (8192, 131072, 1 << 22)}
        assert len(counts) == 1 and counts.pop() <= 16


@pytest.mark.parametrize("shape,heads,dtype,error", [
    ((2, 8, 96), 6, torch.bfloat16, ValueError),    # head_dim 16: not the attention core's
    ((2, 8, 256), 2, torch.bfloat16, ValueError),   # head_dim 128
    ((2, 8, 100), 3, torch.float32, ValueError),    # D not divisible by the heads
    ((2, 8, 64), 2, torch.float16, TypeError),      # neither bf16 nor f32
])
def test_kernel_checks_refuse_what_the_kernels_do_not_take(shape, heads, dtype, error):
    with pytest.raises(error):
        fab._check_kernel_inputs(torch.empty(shape, dtype=dtype), heads, shape[-1])


def test_kernel_checks_refuse_rows_past_the_tma_coordinates():
    # 2^31 elements of qkv; expand makes the shape without the memory
    x = torch.empty(1, 1, 768, dtype=torch.bfloat16).expand(1 << 10, 1 << 10, 768)
    with pytest.raises(ValueError, match="2\\^31"):
        fab._check_kernel_inputs(x, 12, 768)


def test_kernel_checks_pass_the_model_widths_before_the_device():
    # base encoder, predictor and the large model's width reach the device check
    for d, heads in ((768, 12), (384, 12), (1024, 16)):
        with pytest.raises(ValueError, match="cuda"):
            fab._check_kernel_inputs(torch.empty(2, 8, d, dtype=torch.bfloat16), heads, d)


def test_scratch_layout_is_token_major():
    rng = np.random.default_rng(7)
    b, heads, t, hd = 3, 4, 5, 8
    q, k, v = (torch.tensor(rng.standard_normal((b, heads, t, hd)).astype(np.float32))
               for _ in range(3))
    qkv = fab.scratch_from_heads(q, k, v)
    assert qkv.shape == (b * t, 3 * heads * hd)
    # row b·T + t, column part·D + h·hd + i, the kernels' HeadStrides
    d = heads * hd
    for part, a in enumerate((q, k, v)):
        want = a.permute(0, 2, 1, 3).reshape(b * t, d)
        torch.testing.assert_close(qkv[:, part * d:(part + 1) * d], want, rtol=0, atol=0)
        assert qkv[2 * t + 3, part * d + 1 * hd + 5] == a[2, 1, 3, 5]
    for got, want in zip(fab.heads_from_scratch(qkv, b, heads), (q, k, v)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unpack_weights_inverts_pack_weights():
    _, ipk, ipb, opk, *_ = _case(1, 4, 48, 3, seed=8)
    params = [p.detach() for p in _torch_params(ipk, ipb, opk)]
    for got, want in zip(fab.unpack_weights(*fab.pack_weights(*params, 3)), params):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,t,d,heads", [(2, 12, 32, 4), (2, 10, 64, 2)])
def test_module_parameters_route_equals_the_packed_route(b, t, d, heads):
    # the transformer hands its (3D, D), (3D,), (D, D) parameters over as
    # they lie; the old route packed them for the JAX signature. Same
    # outputs and parameter gradients, f32, on the CPU.
    x, ipk, ipb, opk, opb, mask, wl = _case(b, t, d, heads, seed=9)
    outs, grads = [], []
    for packed in (False, True):
        tx = torch.tensor(x, requires_grad=True)
        w, bias, wout = _torch_params(ipk, ipb, opk)
        tb = torch.tensor(opb).requires_grad_(True)
        if packed:
            out = fab.fused_attention_block(tx, *fab.pack_weights(w, bias, wout, heads), tb[None],
                                            torch.tensor(mask))
        else:
            out = fab.fused_self_attention(tx, w, bias, wout, tb, torch.tensor(mask), heads)
        (out * torch.tensor(wl)).sum().backward()
        outs.append(out.detach())
        grads.append([a.grad for a in (tx, w, bias, wout, tb)])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for name, g0, g1 in zip(("x", "in_proj_weight", "in_proj_bias", "out_proj.weight",
                             "out_proj.bias"), *grads):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0, msg=name)
