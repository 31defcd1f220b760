"""Weights in and out of the port's modules.

The port's parameter names are the reference's torch names, so a
reference-format checkpoint (a Lightning ``{"state_dict": ...}`` or a bare
``state_dict``, with or without ``torch.compile``'s ``._orig_mod``
segments) loads with ``load_state_dict`` once the prefixes are stripped.
``state_dict_from_jax_params`` carries the JAX package's flax parameter
tree (nested dicts of arrays) across:

  * a flax Dense ``kernel`` (in, out) becomes a ``weight`` (out, in);
  * conv kernels are OIH in both and carry over as they are;
  * a LayerNorm ``scale`` becomes ``weight``;
  * a per-channel frontend's stacks become ``extract_audio.cnns.{c}``;
  * the decoder, both mappers and ``mask_token`` (1, 1, D_dec) keep their
    names, and an EMA teacher tree becomes ``teacher_encoder.*``, as
    ``wavjepa_tpu/api/convert.py`` exports them;
  * a tree with no decoder (the JAX package's ``DenoiserStudent``) gives
    the encoder side alone, the denoiser student's state_dict.

``state_dict_from_hf_wavlm`` loads a ``transformers`` ``WavLMModel`` state
dict (or a task model's, under ``wavlm.``) into ``models/wavlm.WavLM``'s
names: the frontend's blocks to ``feature_extractor.cnn.{i}``, each layer's
q, k and v projections packed into ``in_proj_weight`` (q | k | v), and the
positional convolution's weight norm folded into one weight.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from wavjepa_tpu_torch.ops.pos_embed import (
    get_1d_sincos_pos_embed_from_grid,
    get_binaural_pos_embed,
)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def strip_compile_prefixes(state_dict: Mapping[str, object]) -> dict[str, object]:
    """Remove the ``._orig_mod`` segments torch.compile puts in names."""
    return {k.replace("._orig_mod", ""): v for k, v in state_dict.items()}


def unwrap_state_dict(ckpt: Mapping[str, object]) -> dict[str, object]:
    """A Lightning checkpoint's ``state_dict``, or the dict itself, with
    compile prefixes stripped."""
    if "state_dict" in ckpt and not hasattr(ckpt["state_dict"], "shape"):
        ckpt = ckpt["state_dict"]
    return strip_compile_prefixes(ckpt)


def load_torch_checkpoint(path: str) -> dict:
    """Read a reference ``.ckpt``/``.pt`` onto the CPU. Lightning
    checkpoints pickle more than tensors, so this unpickles in full: load
    only files from a source you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def detect_pos_embed(
    state_dict: Mapping[str, object],
    encoder_dim: int,
    frames_per_window: int,
    total_patches: int,
    atol: float = 1e-3,
) -> "str | None":
    """Which position table a reference checkpoint stored ("time",
    "binaural"), or None when it stores none or neither matches."""
    sd = unwrap_state_dict(state_dict)
    stored = None
    for key, value in sd.items():
        if key.endswith("pos_encoding_encoder"):
            stored = np.asarray(
                value.detach().cpu().numpy() if hasattr(value, "detach") else value
            )
            break
    if stored is None or stored.size != total_patches * encoder_dim:
        return None
    stored = stored.reshape(total_patches, encoder_dim).astype(np.float64)
    time_table = get_1d_sincos_pos_embed_from_grid(
        encoder_dim, np.arange(total_patches, dtype=np.float64)
    )
    if np.allclose(stored, time_table, atol=atol):
        return "time"
    if total_patches == 2 * frames_per_window and np.allclose(
        stored, get_binaural_pos_embed(encoder_dim, frames_per_window), atol=atol
    ):
        return "binaural"
    return None


def _linear(params: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(params["kernel"]).T.contiguous()
    if "bias" in params:
        out[f"{prefix}.bias"] = _t(params["bias"])


def _layernorm(params: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])


def _encoder(params: Mapping, prefix: str, out: dict) -> None:
    for name, layer in params.items():
        if not name.startswith("layers_"):
            continue
        lp = f"{prefix}.layers.{int(name.split('_')[1])}"
        attn = layer["self_attn"]
        out[f"{lp}.self_attn.in_proj_weight"] = _t(attn["in_proj"]["kernel"]).T.contiguous()
        out[f"{lp}.self_attn.in_proj_bias"] = _t(attn["in_proj"]["bias"])
        _linear(attn["out_proj"], f"{lp}.self_attn.out_proj", out)
        _linear(layer["linear1"], f"{lp}.linear1", out)
        _linear(layer["linear2"], f"{lp}.linear2", out)
        _layernorm(layer["norm1"], f"{lp}.norm1", out)
        _layernorm(layer["norm2"], f"{lp}.norm2", out)
    _layernorm(params["norm"], f"{prefix}.norm", out)


def _conv_stack(blocks: Mapping, prefix: str, extractor_mode: str, out: dict) -> None:
    for name, block in blocks.items():
        bp = f"{prefix}.{int(name.split('_')[1])}"
        out[f"{bp}.0.weight"] = _t(block["kernel"])
        if "bias" in block:
            out[f"{bp}.0.bias"] = _t(block["bias"])
        if "norm_scale" in block:
            norm = f"{bp}.2.1" if extractor_mode == "layer_norm" else f"{bp}.2"
            out[f"{norm}.weight"] = _t(block["norm_scale"])
            out[f"{norm}.bias"] = _t(block["norm_bias"])


def state_dict_from_jax_params(params: Mapping, extractor_mode: str = "default",
                               teacher_encoder: "Mapping | None" = None
                               ) -> dict[str, torch.Tensor]:
    """The JAX package's JEPA params → the port's state_dict: the encoder
    side, and the decoder, mappers and mask token where ``params`` has them;
    ``teacher_encoder`` (an encoder tree) adds ``teacher_encoder.*``.

    ``extractor_mode`` says where a conv block's norm sits: GroupNorm at
    ``cnn.{i}.2`` ("default", block 0 only) or LayerNorm at ``cnn.{i}.2.1``
    ("layer_norm"). A per-channel frontend (``cnn_{c}`` or ``cnn_shared``
    trees) goes to ``extract_audio.cnns.{c}.{i}``, the names the JAX
    package's ``convert_channel_conv_frontend`` reads."""
    out: dict[str, torch.Tensor] = {}
    extractor = params["extract_audio"]
    if any(name.startswith("cnn_") for name in extractor):
        # the per-channel frontend: a stack a channel ("cnn_{c}") or one
        # shared ("cnn_shared"), under the reference's cnns.{c} (cnns.0)
        for name, stack in extractor.items():
            c = 0 if name == "cnn_shared" else int(name.split("_")[1])
            _conv_stack(stack, f"extract_audio.cnns.{c}", extractor_mode, out)
    else:
        _conv_stack(extractor, "extract_audio.cnn", extractor_mode, out)
    _layernorm(params["feature_norms"], "feature_norms", out)
    if "post_extraction_mapper" in params:
        _linear(params["post_extraction_mapper"], "post_extraction_mapper", out)
    _encoder(params["encoder"], "encoder", out)
    if "decoder" in params:
        _encoder(params["decoder"], "decoder", out)
        _linear(params["encoder_to_decoder_mapper"], "encoder_to_decoder_mapper", out)
        _linear(params["decoder_to_encoder_mapper"], "decoder_to_encoder_mapper", out)
        out["mask_token"] = _t(params["mask_token"])
    if teacher_encoder is not None:
        _encoder(teacher_encoder, "teacher_encoder", out)
    return out


def _fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g·v/‖v‖ with the norm over every dim but 2 (weight norm at dim 2)."""
    return g * v / v.norm(dim=(0, 1), keepdim=True)


_HF_POS = "encoder.pos_conv_embed.conv"
_HF_QKV = ("q_proj", "k_proj", "v_proj")
_HF_WEIGHT_NORM = (("weight_g", "weight_v"),
                   ("parametrizations.weight.original0", "parametrizations.weight.original1"))


def state_dict_from_hf_wavlm(hf: Mapping[str, object]) -> dict[str, torch.Tensor]:
    """A ``transformers`` WavLM state dict → ``models/wavlm.WavLM``'s. Keys
    that the encoder does not use (``masked_spec_embed``, a task head's)
    are left out."""
    sd = {k.removeprefix("wavlm."): torch.as_tensor(v).float() for k, v in hf.items()}
    out: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.startswith("feature_extractor.conv_layers."):
            i, rest = key.removeprefix("feature_extractor.conv_layers.").split(".", 1)
            block = f"feature_extractor.cnn.{i}"
            out[f"{block}.0.{rest.removeprefix('conv.')}" if rest.startswith("conv.")
                else f"{block}.2.1.{rest.removeprefix('layer_norm.')}"] = value
        elif key.startswith(("feature_projection.", "encoder.layer_norm.")):
            out[key] = value
        elif key.startswith("encoder.layers.") and key.split(".")[-2] not in _HF_QKV:
            out[key] = value
    for g_key, v_key in _HF_WEIGHT_NORM:
        if f"{_HF_POS}.{g_key}" in sd:
            out[f"{_HF_POS}.weight"] = _fold_weight_norm(sd[f"{_HF_POS}.{g_key}"],
                                                        sd[f"{_HF_POS}.{v_key}"])
    if f"{_HF_POS}.weight" in sd:
        out[f"{_HF_POS}.weight"] = sd[f"{_HF_POS}.weight"]
    out[f"{_HF_POS}.bias"] = sd[f"{_HF_POS}.bias"]
    layers = sorted({int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")})
    for i in layers:
        a = f"encoder.layers.{i}.attention"
        for part in ("weight", "bias"):
            out[f"{a}.in_proj_{part}"] = torch.cat(
                [sd[f"{a}.{n}_proj.{part}"] for n in ("q", "k", "v")])
    return out
