"""Plain WavLM encoder in float32, for the benchmark's WavLM cells.

A copy of the repository's test reference (``tests/wavlm_reference.py``,
written from WavLM's published description, arXiv:2110.13900, and
``microsoft/wavlm-large``'s configuration) with what the benchmark adds:
the seeded weights (``make_weights``), ``q``, which rounds the operands of
every product (``precision.py``; the identity for the reference itself), and
``bias``, which the dropped-bias fault turns off. Plain ``torch`` with TF32
off, each utterance alone at its own length (one utterance at a time fits:
a 35-s one takes ~0.2 GB of scores a layer), the gated relative-position
bias materialised (H, T, T). It imports nothing of the port or of JAX.

Weights are a flat dict under ``transformers``' ``WavLMModel`` names, the
positional convolution's weight norm stored as ``weight_g``/``weight_v``.
``m`` is a configuration file's ``"model"`` section, ``pre`` its
``"preprocessor"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from wavbench.reference.model import float32_matmul
from wavbench.reference.precision import PRECISIONS

POS = "encoder.pos_conv_embed.conv"


def make_weights(m: dict, seed: int, device) -> dict:
    """Seeded float32 weights on ``device`` under ``transformers``' names:
    kaiming-normal convolutions, lecun-normal products (the positional
    convolution's ``weight_v`` standard normal under a weight norm g in
    [1, 1.3]), a standard-normal bucket embedding (its bias as large as
    q·k/8), gate constants in [0.5, 1.5], norms' weights 1 + 0.1·N and
    biases 0.02·N."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63) + 11)

    def normal(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=g, device=device)

    d, h, ff = m["hidden_size"], m["num_attention_heads"], m["intermediate_size"]
    w = {}
    cin = 1
    for i, (c, k) in enumerate(zip(m["conv_dim"], m["conv_kernel"])):
        p = f"feature_extractor.conv_layers.{i}"
        w[f"{p}.conv.weight"] = normal(c, cin, k, std=math.sqrt(2.0 / (cin * k)))
        w[f"{p}.layer_norm.weight"] = normal(c, std=0.1, mean=1.0)
        w[f"{p}.layer_norm.bias"] = normal(c, std=0.02)
        cin = c

    def linear(prefix, n_out, n_in):
        w[f"{prefix}.weight"] = normal(n_out, n_in, std=1.0 / math.sqrt(n_in))
        w[f"{prefix}.bias"] = normal(n_out, std=0.02)

    def norm(prefix, n):
        w[f"{prefix}.weight"] = normal(n, std=0.1, mean=1.0)
        w[f"{prefix}.bias"] = normal(n, std=0.02)

    norm("feature_projection.layer_norm", cin)
    linear("feature_projection.projection", d, cin)
    kpos, groups = m["num_conv_pos_embeddings"], m["num_conv_pos_embedding_groups"]
    w[f"{POS}.weight_g"] = 1.0 + 0.3 * torch.rand(1, 1, kpos, generator=g, device=device)
    w[f"{POS}.weight_v"] = normal(d, d // groups, kpos)
    w[f"{POS}.bias"] = normal(d, std=0.02)
    norm("encoder.layer_norm", d)
    for i in range(m["num_hidden_layers"]):
        p = f"encoder.layers.{i}"
        a = f"{p}.attention"
        for n in ("q", "k", "v", "out"):
            linear(f"{a}.{n}_proj", d, d)
        linear(f"{a}.gru_rel_pos_linear", 8, d // h)
        w[f"{a}.gru_rel_pos_const"] = 0.5 + torch.rand(1, h, 1, 1, generator=g, device=device)
        if i == 0:
            w[f"{a}.rel_attn_embed.weight"] = normal(m["num_buckets"], h)
        norm(f"{p}.layer_norm", d)
        norm(f"{p}.final_layer_norm", d)
        linear(f"{p}.feed_forward.intermediate_dense", ff, d)
        linear(f"{p}.feed_forward.output_dense", d, ff)
    return w


def pos_conv_weight(w: dict) -> torch.Tensor:
    """g·v/‖v‖ with the norm over dims 0 and 1 (weight norm at dim 2)."""
    g, v = w[f"{POS}.weight_g"], w[f"{POS}.weight_v"]
    return g * v / v.norm(dim=(0, 1), keepdim=True)


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


def frames(samples: int, m: dict) -> int:
    for k, s in zip(m["conv_kernel"], m["conv_stride"]):
        samples = (samples - k) // s + 1
    return samples


def encode(wave: torch.Tensor, w: dict, m: dict, pre: dict, q=PRECISIONS["exact"],
           bias: bool = True) -> torch.Tensor:
    """(samples,) audio of one utterance → (T, D) float32 frames."""
    eps = m["layer_norm_eps"]

    def ln(x, prefix, e=eps):
        return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], e)

    def lin(x, prefix):
        return F.linear(q(x), q(w[f"{prefix}.weight"]), w[f"{prefix}.bias"])

    x = (normalize(wave) if pre["do_normalize"] else wave).float()[None, None]
    for i, s in enumerate(m["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(q(x), q(w[f"{p}.conv.weight"]), stride=s)
        x = F.gelu(ln(x.transpose(1, 2), f"{p}.layer_norm", 1e-5).transpose(1, 2))
    x = x[0].t()  # (T, C)
    x = lin(ln(x, "feature_projection.layer_norm"), "feature_projection.projection")
    kpos = m["num_conv_pos_embeddings"]
    pos = F.conv1d(q(x.t()[None]), q(pos_conv_weight(w)), w[f"{POS}.bias"], padding=kpos // 2,
                   groups=m["num_conv_pos_embedding_groups"])[0]
    if kpos % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos).t()
    t, d = x.shape
    h = m["num_attention_heads"]
    hd = d // h
    idx = torch.arange(t, device=x.device)
    rel = idx[None, :] - idx[:, None]  # [q, k] = k − q
    embed = w["encoder.layers.0.attention.rel_attn_embed.weight"]
    position_bias = embed[bucket(rel, m["num_buckets"], m["max_bucket_distance"])]
    position_bias = position_bias.permute(2, 0, 1)  # (H, T, T)
    for i in range(m["num_hidden_layers"]):
        p = f"encoder.layers.{i}"
        a = f"{p}.attention"
        y = ln(x, f"{p}.layer_norm")
        qh, kh, vh = (lin(y, f"{a}.{n}_proj").reshape(t, h, hd).transpose(0, 1)
                      for n in ("q", "k", "v"))
        scores = torch.matmul(q(qh), q(kh).transpose(1, 2)) / math.sqrt(hd)
        if bias:
            u = lin(y.reshape(t, h, hd), f"{a}.gru_rel_pos_linear").reshape(t, h, 2, 4).sum(-1)
            gate_a, gate_c = torch.sigmoid(u).unbind(-1)  # (T, H) each
            kappa = w[f"{a}.gru_rel_pos_const"].reshape(1, h)
            gate = (gate_a * (gate_c * kappa - 1.0) + 2.0).t()  # (H, T)
            scores = scores + gate[:, :, None] * position_bias
        o = torch.matmul(q(torch.softmax(scores, dim=-1)), q(vh))  # (H, T, hd)
        x = x + lin(o.transpose(0, 1).reshape(t, d), f"{a}.out_proj")
        y = ln(x, f"{p}.final_layer_norm")
        ff = f"{p}.feed_forward"
        x = x + lin(F.gelu(lin(y, f"{ff}.intermediate_dense")), f"{ff}.output_dense")
    return ln(x, "encoder.layer_norm")


def scene_embeddings(waves: list, w: dict, m: dict, pre: dict, device,
                     precision: str = "exact", bias: bool = True) -> tuple:
    """Each utterance's mean frame, (B, D) float32, and its frame count,
    each utterance run alone at its own length."""
    q = PRECISIONS[precision]
    out, counts = [], []
    with torch.no_grad(), float32_matmul():
        for x in waves:
            emb = encode(torch.from_numpy(np.asarray(x, np.float32)).to(device), w, m, pre, q,
                         bias)
            out.append(emb.mean(0))
            counts.append(emb.shape[0])
    return torch.stack(out), counts
