"""Plain WavLM encoder in float32: the reference the port's WavLM is held to.

Written from WavLM's published description (Chen et al., arXiv:2110.13900)
and ``microsoft/wavlm-large``'s configuration, in plain ``torch`` with
TF32 off, one utterance at a time at its own length, with the gated
relative-position bias materialised (H, T, T). It imports nothing of the
port or of the JAX package, and has no kernels and no batching.

Weights are a flat dict under ``transformers``' ``WavLMModel`` names; the
positional convolution's weight norm (over dim 2) is taken as stored
(``weight_g``/``weight_v``, or ``parametrizations.weight.original0/1``) or
as one folded ``weight``. ``cfg`` is a dict of the configuration's
published keys (``conv_dim``, ``conv_kernel``, ``conv_stride``,
``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
``layer_norm_eps``, ``num_conv_pos_embeddings``,
``num_conv_pos_embedding_groups``, ``num_buckets``,
``max_bucket_distance``) and ``do_normalize``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

POS = "encoder.pos_conv_embed.conv"


@contextlib.contextmanager
def float32_matmul():
    """Products in full float32: TF32 off for matmul and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def pos_conv_weight(w: dict) -> torch.Tensor:
    """The positional convolution's weight, g·v/‖v‖ with the norm over
    dims 0 and 1 (weight norm at dim 2)."""
    if f"{POS}.weight" in w:
        return w[f"{POS}.weight"]
    for g_key, v_key in (("weight_g", "weight_v"),
                         ("parametrizations.weight.original0", "parametrizations.weight.original1")):
        if f"{POS}.{g_key}" in w:
            g, v = w[f"{POS}.{g_key}"], w[f"{POS}.{v_key}"]
            return g * v / v.norm(dim=(0, 1), keepdim=True)
    raise KeyError(f"no {POS} weight")


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of each offset k − q (an integer tensor)."""
    nb = num_buckets // 2
    exact = nb // 2
    out = (rel > 0).long() * nb
    r = rel.abs()
    large = torch.log(r.float() / exact) / math.log(max_distance / exact) * (nb - exact)
    large = torch.clamp((exact + large).long(), max=nb - 1)
    return out + torch.where(r < exact, r, large)


def normalize(wave: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit variance (biased, + 1e-7 under the root)."""
    return (wave - wave.mean()) / torch.sqrt(wave.var(unbiased=False) + 1e-7)


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], eps)


def _lin(x, w, prefix):
    return F.linear(x, w[f"{prefix}.weight"], w[f"{prefix}.bias"])


def encode(wave: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """(samples,) audio of one utterance → (T, D) float32 frames."""
    eps = cfg["layer_norm_eps"]
    x = (normalize(wave) if cfg.get("do_normalize") else wave).float()[None, None]
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        p = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, w[f"{p}.conv.weight"], w.get(f"{p}.conv.bias"), stride=s)
        x = F.gelu(_ln(x.transpose(1, 2), w, f"{p}.layer_norm", 1e-5).transpose(1, 2))
    x = x[0].t()  # (T, C)
    x = _lin(_ln(x, w, "feature_projection.layer_norm", eps), w, "feature_projection.projection")
    kpos = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.t()[None], pos_conv_weight(w), w[f"{POS}.bias"], padding=kpos // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])[0]
    if kpos % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos).t()
    t, d = x.shape
    h = cfg["num_attention_heads"]
    hd = d // h
    idx = torch.arange(t, device=x.device)
    rel = idx[None, :] - idx[:, None]  # [q, k] = k − q
    embed = w["encoder.layers.0.attention.rel_attn_embed.weight"]
    position_bias = embed[bucket(rel, cfg["num_buckets"], cfg["max_bucket_distance"])]
    position_bias = position_bias.permute(2, 0, 1)  # (H, T, T)
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layers.{i}"
        a = f"{p}.attention"
        y = _ln(x, w, f"{p}.layer_norm", eps)
        q, k, v = (_lin(y, w, f"{a}.{n}_proj").reshape(t, h, hd).transpose(0, 1)
                   for n in ("q", "k", "v"))
        u = _lin(y.reshape(t, h, hd), w, f"{a}.gru_rel_pos_linear").reshape(t, h, 2, 4).sum(-1)
        gate_a, gate_c = torch.sigmoid(u).unbind(-1)  # (T, H) each
        kappa = w[f"{a}.gru_rel_pos_const"].reshape(1, h)
        gate = (gate_a * (gate_c * kappa - 1.0) + 2.0).t()  # (H, T)
        scores = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(hd)
        scores = scores + gate[:, :, None] * position_bias
        o = torch.matmul(torch.softmax(scores, dim=-1), v)  # (H, T, hd)
        x = x + _lin(o.transpose(0, 1).reshape(t, d), w, f"{a}.out_proj")
        y = _ln(x, w, f"{p}.final_layer_norm", eps)
        ff = f"{p}.feed_forward"
        x = x + _lin(F.gelu(_lin(y, w, f"{ff}.intermediate_dense")), w, f"{ff}.output_dense")
    return _ln(x, w, "encoder.layer_norm", eps)


def utterance_embeddings(waves: list, w: dict, cfg: dict) -> list:
    """Each utterance's (T_i, D) frames, each run alone at its own length."""
    with torch.no_grad(), float32_matmul():
        return [encode(torch.as_tensor(x, dtype=torch.float32), w, cfg) for x in waves]
