"""Useful FLOPs of a WavJEPA train step and of a served window.

A frozen copy of ``wavjepa_tpu_torch/utils/flops.py`` (``conv_frontend_flops``,
``transformer_layer_flops``, ``encoder_path_flops``, ``jepa_forward_flops``,
``jepa_step_flops``) as of commit cdac4308582b9b00131171bfbc04c0a840de7394,
reading a configuration file's ``"model"`` section instead of a
``JEPAConfig``. Each multiply-add of a product or convolution counts 2; the
step counts the student forward, the teacher forward and the student's
backward (twice its forward), at the packed lengths where the model packs
tokens; recomputation and elementwise work count nothing.
"""

from __future__ import annotations

from wavbench.reference.model import crop_samples, tokens

H100_BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense bf16


def conv_frontend_flops(conv_spec, in_len: int, in_channels: int = 1) -> int:
    flops, cin, t = 0, in_channels, in_len
    for cout, k, s in conv_spec:
        t = (t - k) // s + 1
        flops += 2 * t * cout * k * cin
        cin = cout
    return flops


def transformer_layer_flops(t: int, d: int, ff: int) -> int:
    proj = 2 * t * d * (3 * d)  # packed QKV
    out = 2 * t * d * d
    attn = 2 * 2 * t * t * d  # QKᵀ and PV over all heads
    mlp = 2 * 2 * t * d * ff
    return proj + out + attn + mlp


def encoder_path_flops(m: dict) -> tuple[int, int, int]:
    """A window's forward FLOPs of (conv frontend, mapper, encoder at full
    length)."""
    t = tokens(m)
    if m["extractor"] == "conv_channel":
        conv = m["in_channels"] * conv_frontend_flops(m["conv_spec"], crop_samples(m), 1)
    else:
        conv = conv_frontend_flops(m["conv_spec"], crop_samples(m), m["in_channels"])
    emb = m["conv_spec"][-1][0]
    mapper = 2 * t * emb * m["encoder_dim"]
    enc = m["encoder_layers"] * transformer_layer_flops(
        t, m["encoder_dim"], int(m["encoder_dim"] * m["mlp_ratio"]))
    return conv, mapper, enc


def jepa_forward_flops(m: dict, n_targets: int = 4) -> dict:
    t = tokens(m)
    pe = m.get("pack_encoder") or t
    pd = m.get("pack_decoder") or t
    conv, mapper, enc_full = encoder_path_flops(m)
    d, dd = m["encoder_dim"], m["decoder_dim"]
    enc_student = m["encoder_layers"] * transformer_layer_flops(pe, d, int(d * m["mlp_ratio"]))
    e2d = 2 * pe * d * dd
    dec = n_targets * m["decoder_layers"] * transformer_layer_flops(
        pd, dd, int(dd * m["mlp_ratio"]))
    d2e = n_targets * 2 * pd * dd * d
    return {"student": conv + mapper + enc_student + e2d + dec + d2e, "teacher": enc_full}


def jepa_step_flops(m: dict, n_crops: int, n_targets: int = 4) -> int:
    f = jepa_forward_flops(m, n_targets)
    return n_crops * (3 * f["student"] + f["teacher"])
