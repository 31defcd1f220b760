"""The least time the chip needs for a cell's attention, from its shapes.

Each attention call (B sequences, H heads, T tokens, head size d) needs at
least the larger of its operations at the bf16 peak and its bytes at the
memory bandwidth. Forward: 4·B·H·T²·d operations (QKᵀ and PV); reading Q,
K, V and the key mask once and writing O and the f32 row statistics once.
Backward: 8·B·H·T²·d, the products the gradient needs (dV, dP, dQ, dK;
recomputing QKᵀ, which a kernel may do, is not needed work); reading Q, K,
V, O, dO, the mask and the statistics once and writing dQ, dK, dV once.
Tensors are bf16 (2 bytes). The shapes are the configuration's, whatever
kernel implements them, so a change that saves work inside a kernel shows
as a higher share, and no count can pass 100% of the time that runs it.
"""

from __future__ import annotations

from wavbench.count.flops import H100_BF16_PEAK_FLOPS
from wavbench.reference.model import tokens

H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
ELEM = 2  # bf16


def call_seconds(b: int, h: int, t: int, d: int, backward: bool) -> float:
    if backward:
        ops = 8 * b * h * t * t * d
        moved = ELEM * b * h * t * d * 8 + b * t + 4 * b * h * t
    else:
        ops = 4 * b * h * t * t * d
        moved = ELEM * b * h * t * d * 4 + b * t + 4 * b * h * t
    return max(ops / H100_BF16_PEAK_FLOPS, moved / H100_HBM_BYTES_PER_S)


def train_step_seconds(m: dict, n_crops: int, n_targets: int = 4) -> float:
    """One train step of ``n_crops`` crops: the student encoder over its
    context budget and the predictor over each target group's budget,
    forward and backward; the teacher over the whole crop, forward. A
    sequence's bound is linear in B, so microbatching does not change it."""
    t = tokens(m)
    pe, pd = m.get("pack_encoder") or t, m.get("pack_decoder") or t
    d, dd = m["encoder_dim"], m["decoder_dim"]
    he, hd = m["encoder_heads"], m["decoder_heads"]
    enc = sum(call_seconds(n_crops, he, pe, d // he, bwd) for bwd in (False, True))
    dec = sum(call_seconds(n_crops * n_targets, hd, pd, dd // hd, bwd) for bwd in (False, True))
    teacher = call_seconds(n_crops, he, t, d // he, False)
    return m["encoder_layers"] * (enc + teacher) + m["decoder_layers"] * dec


def serve_seconds(m: dict, windows: int) -> float:
    """``windows`` served windows: the encoder over each, forward."""
    he = m["encoder_heads"]
    return m["encoder_layers"] * call_seconds(windows, he, tokens(m), m["encoder_dim"] // he,
                                              False)
