"""Plain float32 WavJEPA: its parameters, seeded weights and forward passes.

Written from the published description of WavJEPA (a wav2vec 2.0 style
convolution frontend, a post-norm transformer context encoder, a narrower
predictor over mask tokens, an EMA teacher whose top layers, each
instance-normed, are the targets) and of WavJEPA-Nat (one frontend a
channel, tokens channel-major, binaural positions). Parameters are a flat
dict under the names of the published PyTorch checkpoints, which are also
the names the port loads. Everything runs in float32 with TF32 off; ``q``
rounds the operands of every product (``precision.py``), the identity
for the reference itself.

``m`` is a configuration file's ``"model"`` section.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min  # a masked key: finite, exp underflows to 0


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


# ------------------------------------------------------------------ shapes


def frames_per_window(m: dict) -> int:
    t = int(m["sample_rate"] * m["process_seconds"])
    for _, k, s in m["conv_spec"]:
        t = (t - k) // s + 1
    return t


def tokens(m: dict) -> int:
    """Tokens a window: a channel's frames, times the channels for a frontend
    a channel."""
    n = frames_per_window(m)
    return n * m["in_channels"] if m["extractor"] == "conv_channel" else n


def crop_samples(m: dict) -> int:
    return int(m["sample_rate"] * m["process_seconds"])


def _stack_specs(prefix: str, layers: int, dim: int, mlp: int) -> list:
    specs = []
    for i in range(layers):
        p = f"{prefix}.layers.{i}."
        specs += [
            (p + "self_attn.in_proj_weight", (3 * dim, dim), "lecun"),
            (p + "self_attn.in_proj_bias", (3 * dim,), "zeros"),
            (p + "self_attn.out_proj.weight", (dim, dim), "lecun"),
            (p + "self_attn.out_proj.bias", (dim,), "zeros"),
            (p + "linear1.weight", (mlp, dim), "lecun"),
            (p + "linear1.bias", (mlp,), "zeros"),
            (p + "linear2.weight", (dim, mlp), "lecun"),
            (p + "linear2.bias", (dim,), "zeros"),
            (p + "norm1.weight", (dim,), "ones"),
            (p + "norm1.bias", (dim,), "zeros"),
            (p + "norm2.weight", (dim,), "ones"),
            (p + "norm2.bias", (dim,), "zeros"),
        ]
    return specs + [(f"{prefix}.norm.weight", (dim,), "ones"),
                    (f"{prefix}.norm.bias", (dim,), "zeros")]


def _frontend_specs(prefix: str, spec, in_c: int) -> list:
    specs = []
    for i, (dim, k, _) in enumerate(spec):
        specs.append((f"{prefix}.{i}.0.weight", (dim, in_c, k), "kaiming"))
        if i == 0:  # GroupNorm(C, C) on the first block
            specs += [(f"{prefix}.0.2.weight", (dim,), "ones"),
                      (f"{prefix}.0.2.bias", (dim,), "zeros")]
        in_c = dim
    return specs


def param_specs(m: dict, training: bool = True) -> list:
    """(name, shape, init) of every parameter; the serving side alone
    without ``training``."""
    spec = m["conv_spec"]
    emb, d = spec[-1][0], m["encoder_dim"]
    if m["extractor"] == "conv_channel":
        specs = []
        for c in range(m["in_channels"]):
            specs += _frontend_specs(f"extract_audio.cnns.{c}", spec, 1)
    else:
        specs = _frontend_specs("extract_audio.cnn", spec, m["in_channels"])
    specs += [("feature_norms.weight", (emb,), "ones"), ("feature_norms.bias", (emb,), "zeros"),
              ("post_extraction_mapper.weight", (d, emb), "small"),
              ("post_extraction_mapper.bias", (d,), "zeros")]
    specs += _stack_specs("encoder", m["encoder_layers"], d, int(d * m["mlp_ratio"]))
    if training:
        dd = m["decoder_dim"]
        specs += _stack_specs("decoder", m["decoder_layers"], dd, int(dd * m["mlp_ratio"]))
        specs += [("encoder_to_decoder_mapper.weight", (dd, d), "small"),
                  ("encoder_to_decoder_mapper.bias", (dd,), "zeros"),
                  ("decoder_to_encoder_mapper.weight", (d, dd), "small"),
                  ("decoder_to_encoder_mapper.bias", (d,), "zeros"),
                  ("mask_token", (1, 1, dd), "small")]
    return specs


def _std(shape, init: str) -> float:
    if init == "kaiming":  # fan-in, leaky-ReLU (a = 0.01) gain
        return math.sqrt(2.0 / (1.0 + 0.01**2)) / math.sqrt(shape[1] * shape[2])
    if init == "lecun":
        return 1.0 / math.sqrt(shape[1])
    return 0.02


def make_weights(m: dict, seed: int, device, training: bool = True) -> dict:
    """Seeded float32 weights on ``device``: one normal draw from a
    generator on the device for every random leaf, cut and scaled by its
    initialiser; unit norm scales, zero biases. The same seed gives the same
    weights."""
    specs = param_specs(m, training)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    random = [(n, s, i) for n, s, i in specs if i not in ("ones", "zeros")]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in random), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in random:
        size = math.prod(shape)
        out[name] = (flat[at:at + size] * _std(shape, init)).reshape(shape)
        at += size
    for name, shape, init in specs:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in specs}


# --------------------------------------------------------------- positions


def _sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.outer(np.asarray(pos, np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_table(m: dict, dim: int, device) -> torch.Tensor:
    """(T, dim): sin-cos over the token index ("time"), or for binaural
    scenes a time code in the first half and a channel code in the second
    (left zeros, right the code of position 1)."""
    n = frames_per_window(m)
    if m["pos_embed"] == "binaural":
        time_code = _sincos(dim // 2, np.arange(n))
        right = np.tile(_sincos(dim // 2, np.arange(1)), (n, 1))
        table = np.concatenate([np.concatenate([time_code, np.zeros_like(right)], 1),
                                np.concatenate([time_code, right], 1)], 0)
    else:
        table = _sincos(dim, np.arange(tokens(m)))
    return torch.from_numpy(table.astype(np.float32)).to(device)


# ----------------------------------------------------------------- layers


def linear(x, w, b, q):
    return F.linear(q(x), q(w), b)


def layer_norm(x, w, b, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def attention(x, P, pre: str, heads: int, key_mask, q):
    """Multi-head self-attention; ``key_mask`` (B, T) True = not a key."""
    b, t, d = x.shape
    qkv = linear(x, P[pre + "in_proj_weight"], P[pre + "in_proj_bias"], q)
    qh, kh, vh = (z.reshape(b, t, heads, d // heads).transpose(1, 2) for z in qkv.split(d, -1))
    s = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(d // heads)
    p = torch.softmax(s.masked_fill(key_mask[:, None, None, :], NEG), dim=-1)
    o = (q(p) @ q(vh)).transpose(1, 2).reshape(b, t, d)
    return linear(o, P[pre + "out_proj.weight"], P[pre + "out_proj.bias"], q)


def transformer(x, P, prefix: str, layers: int, heads: int, key_mask, eps: float, q,
                every_layer: bool = False):
    """Post-norm blocks, x = LN(x + SA(x)), x = LN(x + MLP(x)), exact GELU.
    The final norm's output, or with ``every_layer`` each block's output
    before it."""
    outs = []
    for i in range(layers):
        p = f"{prefix}.layers.{i}."
        x = layer_norm(x + attention(x, P, p + "self_attn.", heads, key_mask, q),
                       P[p + "norm1.weight"], P[p + "norm1.bias"], eps)
        h = linear(F.gelu(linear(x, P[p + "linear1.weight"], P[p + "linear1.bias"], q)),
                   P[p + "linear2.weight"], P[p + "linear2.bias"], q)
        x = layer_norm(x + h, P[p + "norm2.weight"], P[p + "norm2.bias"], eps)
        outs.append(x)
    if every_layer:
        return outs
    return layer_norm(x, P[f"{prefix}.norm.weight"], P[f"{prefix}.norm.bias"], eps)


def _frontend_stack(x, P, prefix: str, spec, q):
    for i, (_, _, stride) in enumerate(spec):
        x = F.conv1d(q(x), q(P[f"{prefix}.{i}.0.weight"]), stride=stride)
        if i == 0:  # per (sample, channel) over time
            mean = x.mean(dim=-1, keepdim=True)
            var = (x - mean).square().mean(dim=-1, keepdim=True)
            x = ((x - mean) / torch.sqrt(var + 1e-5) * P[f"{prefix}.0.2.weight"][:, None]
                 + P[f"{prefix}.0.2.bias"][:, None])
        x = F.gelu(x)
    return x  # (B, E, T')


def features(audio, P, m: dict, q):
    """(B, C, samples) windows → (B, T, D) positioned encoder inputs."""
    spec = m["conv_spec"]
    if m["extractor"] == "conv_channel":
        per = [_frontend_stack(audio[:, c:c + 1], P, f"extract_audio.cnns.{c}", spec, q)
               for c in range(audio.shape[1])]
        x = torch.cat([y.transpose(1, 2) for y in per], dim=1)  # channel-major tokens
    else:
        x = _frontend_stack(audio, P, "extract_audio.cnn", spec, q).transpose(1, 2)
    x = layer_norm(x, P["feature_norms.weight"], P["feature_norms.bias"], 1e-5)
    x = linear(x, P["post_extraction_mapper.weight"], P["post_extraction_mapper.bias"], q)
    return x + pos_table(m, m["encoder_dim"], x.device)


def encode(audio, P, m: dict, key_mask, q):
    """The serving path: features → context encoder (final norm)."""
    x = features(audio, P, m, q)
    return transformer(x, P, "encoder", m["encoder_layers"], m["encoder_heads"], key_mask,
                       m["layer_norm_eps"], q)
