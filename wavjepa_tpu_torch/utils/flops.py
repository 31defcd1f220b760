"""Analytic FLOP counts of the JEPA and denoise train steps, for MFU.

Counterpart of ``wavjepa_tpu/utils/flops.py``, with the same counts: the
useful model FLOPs (each multiply-add of a product or convolution counts 2)
of the student forward, the teacher forward and the backward (twice the
student forward), the usual MFU convention, which leaves out recomputation
and elementwise work. With visible-token packing the encoder and predictor
are counted at their packed lengths, the work the step does. The peak is
the H100's dense bf16 rate.
"""

from __future__ import annotations

H100_BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense bf16


def conv_output_lengths(conv_spec, in_len: int) -> list[int]:
    outs = []
    t = in_len
    for _, k, s in conv_spec:
        t = (t - k) // s + 1
        outs.append(t)
    return outs


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


def encoder_path_flops(cfg) -> tuple[int, int, int]:
    """Per-crop forward FLOPs of (conv frontend, mapper, encoder at full
    length), the path shared by the SSL student and teacher and the denoise
    views."""
    t = cfg.total_patches
    if cfg.extractor == "conv_channel":
        # a frontend per channel, each on one input channel (the shared-weight
        # variant does the same work)
        conv = cfg.in_channels * conv_frontend_flops(cfg.conv_spec, cfg.target_length, 1)
    else:
        conv = conv_frontend_flops(cfg.conv_spec, cfg.target_length, cfg.in_channels)
    mapper = 2 * t * cfg.embedding_dim * cfg.encoder_dim
    enc_full = cfg.encoder_layers * transformer_layer_flops(
        t, cfg.encoder_dim, int(cfg.encoder_dim * cfg.mlp_ratio))
    return conv, mapper, enc_full


def jepa_forward_flops(cfg, n_targets: int = 4) -> dict:
    """Per-crop forward FLOPs of the student and the teacher for a
    ``JEPAConfig``, at the packed lengths where packing is on."""
    t = cfg.total_patches
    pe = cfg.pack_encoder or t
    pd = cfg.pack_decoder or t
    conv, mapper, enc_full = encoder_path_flops(cfg)
    enc_student = cfg.encoder_layers * transformer_layer_flops(
        pe, cfg.encoder_dim, int(cfg.encoder_dim * cfg.mlp_ratio))
    e2d = 2 * pe * cfg.encoder_dim * cfg.decoder_dim
    dec = n_targets * cfg.decoder_layers * transformer_layer_flops(
        pd, cfg.decoder_dim, int(cfg.decoder_dim * cfg.mlp_ratio))
    d2e = n_targets * 2 * pd * cfg.decoder_dim * cfg.encoder_dim
    student = conv + mapper + enc_student + e2d + dec + d2e
    # the teacher reads the student's frontend features (the step shares
    # them without a gradient), so only its encoder runs, at full length
    return {"student": student, "teacher": enc_full}


def jepa_step_flops(cfg, n_crops: int, n_targets: int = 4) -> int:
    """Useful FLOPs of one train step of ``n_crops`` crops: student
    forward, teacher forward and the student's backward (2× its forward)."""
    f = jepa_forward_flops(cfg, n_targets)
    return n_crops * (3 * f["student"] + f["teacher"])


def denoise_step_flops(cfg, n_crops: int, alpha: float | None = None,
                       clean_forward: bool = True) -> int:
    """FLOPs of one denoise-distillation step of ``n_crops`` crops: the
    student's encoder path at full length, forward and backward on the clean
    and the noisy view, and one teacher forward on the clean view. At
    ``alpha`` 0 or 1 the dead view runs forward only (or not at all, when it
    is the clean view and ``clean_forward`` is false)."""
    conv, mapper, enc = encoder_path_flops(cfg)
    fwd = conv + mapper + enc
    if alpha is not None and float(alpha) in (0.0, 1.0):
        dead = fwd if (clean_forward or float(alpha) == 1.0) else 0
        return n_crops * (dead + 3 * fwd + fwd)
    return n_crops * (2 * 3 * fwd + fwd)


def mfu(flops_per_step: int, step_seconds: float, peak: float = H100_BF16_PEAK_FLOPS,
        n_cards: int = 1) -> float:
    """Model FLOPs utilization a card: the step's useful FLOPs (of the whole
    global batch, over all ``n_cards`` ranks) a second over ``n_cards``
    peaks. Under tensor parallelism ``n_cards`` is every rank, data- and
    tensor-parallel (the world): the mp ranks of a replica share its FLOPs,
    and a block's all-reduces and the frozen denoise teacher's repeated
    forward count as no useful work."""
    return flops_per_step / (step_seconds * n_cards * peak)
