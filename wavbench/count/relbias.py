"""Useful FLOPs of WavLM's served utterances, and the least time the chip
needs for its gated relative-position bias attention (the ``relbias_flash``
kernel's work), from the configuration's shapes.

An utterance's forward: the convolution frontend at its own length
(``count/flops.conv_frontend_flops``), the feature projection, the
positional convolution (2·T·D·(D/groups)·K), and each layer's products
(``count/flops.transformer_layer_flops``: packed QKV, output projection,
QKᵀ and PV, the feed-forward) plus its gate's Linear(64 → 8) per head; each
multiply-add counts 2, elementwise work nothing. Padding is not useful work.

The attention of a request of B utterances padded to T frames, a layer:
4·B·H·T²·d operations at the bf16 peak against the bytes read and written
once at the memory bandwidth: q, k, v and o in bf16, the key mask, the
per-offset table (H, 256·⌈T/128⌉) and the gate (B, H, T) in f32. The kernel
computes over the padded T, so that is what its inputs need.
"""

from __future__ import annotations

from wavbench.count.attention import H100_HBM_BYTES_PER_S
from wavbench.count.flops import (
    H100_BF16_PEAK_FLOPS,
    conv_frontend_flops,
    transformer_layer_flops,
)
from wavbench.reference.wavlm import frames


def utterance_flops(m: dict, samples: int) -> int:
    spec = list(zip(m["conv_dim"], m["conv_kernel"], m["conv_stride"]))
    t, d = frames(samples, m), m["hidden_size"]
    conv = conv_frontend_flops(spec, samples, 1)
    proj = 2 * t * m["conv_dim"][-1] * d
    pos = 2 * t * d * (d // m["num_conv_pos_embedding_groups"]) * m["num_conv_pos_embeddings"]
    gate = 2 * t * d * 8
    layer = transformer_layer_flops(t, d, m["intermediate_size"]) + gate
    return conv + proj + pos + m["num_hidden_layers"] * layer


def call_seconds(b: int, h: int, t: int, d: int) -> float:
    nb = -(-t // 128)
    moved = 2 * b * h * t * d * 4 + b * t + 4 * h * 256 * nb + 4 * b * h * t
    return max(4 * b * h * t * t * d / H100_BF16_PEAK_FLOPS, moved / H100_HBM_BYTES_PER_S)


def request_seconds(m: dict, utterances: int, padded_frames: int) -> float:
    """A request's biased attention over every layer, at the least."""
    h = m["num_attention_heads"]
    return m["num_hidden_layers"] * call_seconds(utterances, h, padded_frames,
                                                 m["hidden_size"] // h)
