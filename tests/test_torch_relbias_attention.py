"""WavLM's gated relative-position bias in the attention
(``ops/flash_attention.relbias_attention``): the table's layout, the plain
route against the formula written out, and, on a card, the ``relbias_flash``
kernels against the plain f32 formula at serving shapes and at the tile
edges, with masked keys, and against the unbiased kernel when the bias is
zero.

The card's cases carry the ``card`` marker and skip without CUDA; run them
on the card with ``python -m pytest --noconftest
tests/test_torch_relbias_attention.py -m card`` (the conftest imports JAX,
which that machine does not have).
"""

import math

import pytest
import torch

from wavjepa_tpu_torch.ops import flash_attention as FA

BF16_ATOL = 1e-2  # bf16 output: ~1 ulp at |o| < 2, plus P rounded in another order
BF16_RTOL = 2.0**-7  # and one ulp of |o| above: the bias sharpens P, so |o| reaches 2-4
F32_ATOL = 1e-5  # f32: the same maths, summed in another order
F32_RTOL = 1e-5  # and over 1,749 keys the sums' order moves |o| of 2-4 by ~1e-5


def assert_near(out, ref, dtype):
    """Within the tolerance of ``dtype``'s rounding of the output."""
    rtol = BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    excess = (out.float() - ref.float()).abs() - (atol + rtol * ref.float().abs())
    assert excess.max().item() <= 0, excess.max().item()


def inputs(b, h, t, d, seed, device="cpu", masked=True):
    """q, k, v (B, H, T, d) f32, a key mask with a tail and scattered keys
    masked (batch row 0 fully masked where ``masked`` and B > 1), a table
    in the kernel's layout and a (B, H, T) gate in WavLM's range (1, 3)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g) for _ in range(3))
    mask = torch.zeros(b, t, dtype=torch.bool)
    if masked:
        mask |= torch.rand(b, t, generator=g) < 0.1
        for i in range(b):
            mask[i, t - (i * t) // (2 * b):] = True
        if b > 1:
            mask[0] = True
    table = torch.randn(h, FA.relbias_offsets(t).numel(), generator=g)
    gate = 1.0 + 2.0 * torch.rand(b, h, t, generator=g)
    return tuple(x.to(device) for x in (q, k, v, mask, table, gate))


def formula(q, k, v, mask, table, gate):
    """The attention written out: f32 scores q·kᵀ/√d + gate[q]·table[k − q],
    masked keys at the f32 minimum, softmax, P·V."""
    t = q.shape[2]
    off = FA.relbias_offsets(t)
    pos = torch.arange(t)
    rel = (pos[None, :] - pos[:, None]).reshape(-1)  # [q, k] flattened
    col = torch.searchsorted(off, rel)
    bias = gate[..., None] * table[:, col].reshape(q.shape[1], t, t)[None]
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]) + bias
    s = s.masked_fill(mask[:, None, None, :], torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def test_offsets_cover_every_offset_with_aligned_windows():
    for t in (1, 63, 128, 129, 880, 1749):
        off = FA.relbias_offsets(t)
        nb = -(-t // 128)
        assert off.numel() == 256 * nb and off[0] == -(128 * nb - 1)
        assert torch.equal(off[1:] - off[:-1], torch.ones(off.numel() - 1, dtype=off.dtype))
        assert off.min() <= -(t - 1) and off.max() >= t - 1


@pytest.mark.parametrize("t", [1, 5, 63, 130])
def test_plain_route_is_the_formula(t):
    q, k, v, mask, table, gate = inputs(3, 2, t, 8, seed=t)
    out = FA.relbias_attention(q, k, v, mask, table, gate)
    torch.testing.assert_close(out, formula(q, k, v, mask, table, gate), rtol=1e-5, atol=1e-6)
    # a fully masked row is uniform over the real keys, bias or not
    torch.testing.assert_close(out[0], v[0].mean(1, keepdim=True).expand_as(v[0]), rtol=1e-5,
                               atol=1e-6)


def test_plain_route_without_bias_is_flash_attention():
    q, k, v, mask, table, gate = inputs(2, 2, 40, 8, seed=7)
    out = FA.relbias_attention(q, k, v, mask, torch.zeros_like(table), gate)
    assert torch.equal(out, FA.flash_attention(q, k, v, mask))


def test_shapes_are_checked():
    q, k, v, mask, table, gate = inputs(2, 2, 40, 8, seed=8)
    with pytest.raises(ValueError, match="table"):
        FA.relbias_attention(q, k, v, mask, table[:, :-1], gate)
    with pytest.raises(ValueError, match="gate"):
        FA.relbias_attention(q, k, v, mask, table, gate[:, :, :-1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        FA.relbias_flash_attention_fwd(q, k, v, mask, table, gate)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the kernels have no CPU mode")
    return torch.device("cuda")


# serving shapes (a request of 16 utterances padded to the 35-s maximum, and
# to the longest of the others) and the tile edges
CARD_SHAPES = [(16, 16, 1749, 64), (16, 16, 880, 64), (4, 16, 1, 64), (4, 16, 63, 64),
               (4, 16, 65, 64), (4, 16, 129, 64), (4, 4, 200, 32)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_the_plain_formula(card, shape, dtype):
    q, k, v, mask, table, gate = inputs(*shape, seed=sum(shape), device=card)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = FA.relbias_flash_attention_fwd.launches
    out = FA.relbias_attention(q, k, v, mask, table, gate)
    assert FA.relbias_flash_attention_fwd.launches == before + 1
    ref = FA.flash_attention_reference(q, k, v, mask, FA.relbias_dense(table, gate))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert_near(out, ref, dtype)
    if shape[2] > 1:  # the bias moves the output far beyond the tolerance (one key: P = 1)
        plain = FA.flash_attention_reference(q, k, v, mask)
        assert (plain.float() - ref.float()).abs().max().item() > 20 * BF16_ATOL


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_zero_bias_is_the_unbiased_kernel(card, shape):
    q, k, v, mask, table, gate = inputs(*shape, seed=1 + sum(shape), device=card)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out = FA.relbias_attention(q, k, v, mask, torch.zeros_like(table), torch.ones_like(gate))
    unbiased = FA.flash_attention_fwd(q, k, v, mask)[0]
    ulp = torch.finfo(torch.bfloat16).eps * unbiased.float().abs().clamp_min(2**-126)
    assert ((out.float() - unbiased.float()).abs() <= ulp).all()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_unbiased_kernel_still_matches_the_plain_formula(card, shape, dtype):
    """The unbiased instantiation of the forward core, which the biased one
    now shares its body with."""
    q, k, v, mask, _, _ = inputs(*shape, seed=2 + sum(shape), device=card)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = FA.flash_attention_fwd(q, k, v, mask)[0]
    assert_near(out, FA.flash_attention_reference(q, k, v, mask), dtype)
