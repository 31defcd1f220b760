"""transformers-native WavJEPA: ``AutoModel.from_pretrained`` on a local
export, the idiom the published ``labhamlet/wavjepa-base`` is loaded with:

    extractor = AutoFeatureExtractor.from_pretrained(dir)
    model = AutoModel.from_pretrained(dir)           # offline local dir
    emb, ts = model(extractor(audio)["input_values"])

Counterpart of ``wavjepa_tpu/api/hf_transformers.py``, whose forward bridges
to a JAX runtime. Here ``WavJEPATransformersModel`` is a ``PreTrainedModel``
that holds the port's serving modules (``models/jepa.py:EncoderPath``: the
conv frontend, ``feature_norms``, ``post_extraction_mapper``, ``encoder``)
under the reference's state-dict names, and its forward is that path, windowed
by ``api/runtime.RuntimeJEPA``. ``model.safetensors`` loads straight into them.

* ``model_type`` is ``wavjepa_tpu_torch``, not the JAX package's
  ``wavjepa_tpu``: a process that imports both registers both.
* A directory the JAX package exported loads too
  (``WavJEPATransformersModel.from_pretrained(dir)``): its decoder weights
  and stored position tables are dropped by name (every key outside
  ``ENCODER_SIDE``, as ``api/runtime.load_model`` drops them); a missing or
  unexpected encoder-side key, or a shape that does not fit, raises.
* ``from_pretrained`` places the model on ``cuda`` unless ``device="cpu"``
  is given, and raises when there is no card.
* Importing this module registers the classes with AutoConfig, AutoModel
  and AutoFeatureExtractor; an export carries this file and an ``auto_map``
  for ``trust_remote_code=True`` (which needs ``wavjepa_tpu_torch``
  importable).

    python -m wavjepa_tpu_torch.api.hf_transformers CKPT OUT_DIR

exports a port or reference ``.ckpt``. This is the one module of the port
that imports ``transformers``.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Optional, Union

import torch
from transformers import PretrainedConfig, PreTrainedModel
from transformers.feature_extraction_utils import BatchFeature, FeatureExtractionMixin

from wavjepa_tpu_torch.api.hf import WavJEPAFeatureExtractor
from wavjepa_tpu_torch.api.runtime import DeviceLike, RuntimeJEPA, load_model, resolve_device
from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE, EncoderPath, JEPAConfig

MODEL_TYPE = "wavjepa_tpu_torch"
MODELING_FILE = "modeling_wavjepa_tpu_torch"

_CONFIG_FIELDS = (
    "conv_spec",
    "in_channels",
    "extractor",
    "extractor_mode",
    "conv_bias",
    "share_weights_over_channels",
    "encoder_layers",
    "encoder_dim",
    "encoder_heads",
    "decoder_layers",
    "decoder_dim",
    "decoder_heads",
    "mlp_ratio",
    "layer_norm_eps",
    "size",
    "sample_rate",
    "process_seconds",
    "average_top_k_layers",
    "pos_embed",
)


class WavJEPATransformersConfig(PretrainedConfig):
    """``PretrainedConfig`` mirror of ``models.jepa.JEPAConfig``'s
    architecture fields (the JAX package's list); the model computes in
    float32, as the JAX package's transformers model does."""

    model_type = MODEL_TYPE

    def __init__(
        self,
        conv_spec: Any = None,
        in_channels: int = 1,
        extractor: str = "conv",
        extractor_mode: str = "default",
        conv_bias: bool = False,
        share_weights_over_channels: bool = False,
        encoder_layers: int = 12,
        encoder_dim: int = 768,
        encoder_heads: int = 12,
        decoder_layers: int = 12,
        decoder_dim: int = 384,
        decoder_heads: int = 12,
        mlp_ratio: float = 4.0,
        layer_norm_eps: float = 1e-6,
        size: str = "base",
        sample_rate: int = 16000,
        process_seconds: float = 2.01,
        average_top_k_layers: int = 8,
        pos_embed: str = "time",
        **kwargs,
    ):
        self.conv_spec = conv_spec  # list of [out, kernel, stride]; None: the default
        self.in_channels = in_channels
        self.extractor = extractor
        self.extractor_mode = extractor_mode
        self.conv_bias = conv_bias
        self.share_weights_over_channels = share_weights_over_channels
        self.encoder_layers = encoder_layers
        self.encoder_dim = encoder_dim
        self.encoder_heads = encoder_heads
        self.decoder_layers = decoder_layers
        self.decoder_dim = decoder_dim
        self.decoder_heads = decoder_heads
        self.mlp_ratio = mlp_ratio
        self.layer_norm_eps = layer_norm_eps
        self.size = size
        self.sample_rate = sample_rate
        self.process_seconds = process_seconds
        self.average_top_k_layers = average_top_k_layers
        self.pos_embed = pos_embed
        super().__init__(**kwargs)

    def to_jepa_config(self) -> JEPAConfig:
        kwargs = {f: getattr(self, f) for f in _CONFIG_FIELDS}
        if kwargs["conv_spec"] is None:
            kwargs.pop("conv_spec")
        else:
            kwargs["conv_spec"] = tuple(tuple(s) for s in kwargs["conv_spec"])
        return JEPAConfig(**kwargs)

    @classmethod
    def from_jepa_config(cls, cfg: JEPAConfig, **kwargs) -> "WavJEPATransformersConfig":
        vals = {f: getattr(cfg, f) for f in _CONFIG_FIELDS}
        vals["conv_spec"] = [list(s) for s in cfg.conv_spec]
        vals.update(kwargs)
        return cls(**vals)


class WavJEPATransformersModel(PreTrainedModel):
    """AutoModel-loadable WavJEPA whose forward is the port's encoder path.

    ``forward(input_values)`` → ``(embeddings (B, S, E), timestamps_ms
    (B, S))`` torch tensors on the model's device: the tuple the published
    Hub model returns."""

    config_class = WavJEPATransformersConfig
    main_input_name = "input_values"
    base_model_prefix = "wavjepa"
    # a JAX package export's decoder, mappers, mask token and stored tables
    _keys_to_ignore_on_load_unexpected = [
        "^(?!(" + "|".join(p.replace(".", r"\.") for p in ENCODER_SIDE) + "))"]

    # the serving path of EncoderPath, over the modules held here
    encode_features = EncoderPath.encode_features
    represent = EncoderPath.represent

    def __init__(self, config: WavJEPATransformersConfig):
        super().__init__(config)
        self.jepa_config = config.to_jepa_config()
        path = EncoderPath(self.jepa_config)
        self.extract_audio = path.extract_audio
        self.feature_norms = path.feature_norms
        self.post_extraction_mapper = path.post_extraction_mapper
        self.encoder = path.encoder
        self.register_buffer("pos_encoding_encoder", path.pos_encoding_encoder,
                             persistent=False)
        self.post_init()

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, *model_args,
                        device: DeviceLike = None, **kwargs):
        dev = resolve_device(device)
        model, info = super().from_pretrained(pretrained_model_name_or_path, *model_args,
                                              output_loading_info=True, **kwargs)
        if info["missing_keys"] or info["unexpected_keys"] or info["mismatched_keys"]:
            raise KeyError(f"{pretrained_model_name_or_path} does not fit the encoder path: "
                           f"missing {sorted(info['missing_keys'])}, unexpected "
                           f"{sorted(info['unexpected_keys'])}, mismatched "
                           f"{info['mismatched_keys']}")
        return model.to(dev).eval()

    def forward(self, input_values, sampling_rate: Optional[int] = None):
        if sampling_rate is not None and sampling_rate != self.config.sample_rate:
            raise ValueError(f"model expects {self.config.sample_rate} Hz, got {sampling_rate}")
        # api/runtime's windowing over these modules, built once a device
        runtime = self.__dict__.get("_runtime")
        if runtime is None or runtime.device != self.device:
            runtime = self.__dict__["_runtime"] = RuntimeJEPA(
                self.jepa_config, device=self.device, model=self)
        return runtime.get_timestamp_embeddings(input_values)


class WavJEPATorchFeatureExtractor(FeatureExtractionMixin):
    """AutoFeatureExtractor analog over ``api/hf.WavJEPAFeatureExtractor``,
    returning a ``BatchFeature`` with ``input_values``. AutoFeatureExtractor
    finds a registered class by the name that ``preprocessor_config.json``
    records, so this name differs from the JAX package's
    (``WavJEPATransformersFeatureExtractor``)."""

    def __init__(self, sampling_rate: int = 16000, in_channels: int = 1, **kwargs):
        self.sampling_rate = sampling_rate
        self.in_channels = in_channels
        super().__init__(**kwargs)

    def __call__(self, audio, sampling_rate: Optional[int] = None, return_tensors=None):
        arr = WavJEPAFeatureExtractor(self.sampling_rate, self.in_channels)(audio, sampling_rate)
        return BatchFeature({"input_values": arr}, tensor_type=return_tensors)


def export_transformers_pretrained(
    save_dir: Union[str, Path],
    model_or_checkpoint: Union[EncoderPath, RuntimeJEPA, str, Path],
    **load_kwargs,
) -> Path:
    """Write a directory that offline ``AutoModel.from_pretrained`` loads:
    ``config.json`` with ``auto_map``, ``model.safetensors`` (the encoder
    side under the reference's names), ``preprocessor_config.json`` and this
    module as ``modeling_wavjepa_tpu_torch.py``. ``model_or_checkpoint`` is
    the port's model, a runtime, or a port or reference ``.ckpt``, read on
    the CPU by ``api/runtime.load_model`` with ``load_kwargs``."""
    if isinstance(model_or_checkpoint, (str, Path)):
        model_or_checkpoint = load_model(str(model_or_checkpoint), device="cpu", **load_kwargs)
    if isinstance(model_or_checkpoint, RuntimeJEPA):
        model_or_checkpoint = model_or_checkpoint.model
    cfg = model_or_checkpoint.config
    save_dir = Path(save_dir)
    hf_cfg = WavJEPATransformersConfig.from_jepa_config(cfg)
    hf_cfg.auto_map = {
        "AutoConfig": f"{MODELING_FILE}.WavJEPATransformersConfig",
        "AutoModel": f"{MODELING_FILE}.WavJEPATransformersModel",
        "AutoFeatureExtractor": f"{MODELING_FILE}.WavJEPATorchFeatureExtractor",
    }
    model = WavJEPATransformersModel(hf_cfg)
    encoder_side = {k: v.detach().float().cpu() for k, v in
                    model_or_checkpoint.state_dict().items() if k.startswith(ENCODER_SIDE)}
    model.load_state_dict(encoder_side, strict=True)
    model.save_pretrained(save_dir)
    WavJEPATorchFeatureExtractor(
        sampling_rate=cfg.sample_rate, in_channels=cfg.in_channels).save_pretrained(save_dir)
    shutil.copyfile(__file__, save_dir / f"{MODELING_FILE}.py")
    return save_dir


def register_auto_classes() -> None:
    """Register with AutoConfig, AutoModel and AutoFeatureExtractor, once."""
    from transformers import AutoConfig, AutoFeatureExtractor, AutoModel

    try:
        AutoConfig.register(MODEL_TYPE, WavJEPATransformersConfig)
    except ValueError:  # registered by an earlier import
        return
    AutoModel.register(WavJEPATransformersConfig, WavJEPATransformersModel)
    AutoFeatureExtractor.register(WavJEPATransformersConfig, WavJEPATorchFeatureExtractor)


if not __name__.startswith("transformers_modules"):
    # the copy that trust_remote_code loads resolves its classes through
    # auto_map; registering it too would collide with this one
    register_auto_classes()


def _main(argv=None) -> int:
    """Export a port or reference ``.ckpt`` (or, with "", seeded random
    weights) as a transformers directory."""
    import argparse

    parser = argparse.ArgumentParser(prog="wavjepa_tpu_torch.api.hf_transformers",
                                     description=_main.__doc__)
    parser.add_argument("ckpt")
    parser.add_argument("out_dir")
    parser.add_argument("--size", default="base", choices=["base", "large", "tiny"])
    parser.add_argument("--in-channels", type=int, default=1)
    parser.add_argument("--channel-wise", action="store_true")
    args = parser.parse_args(argv)
    out = export_transformers_pretrained(
        args.out_dir, args.ckpt, model_size=args.size, in_channels=args.in_channels,
        channel_wise=args.channel_wise)
    print(f"exported transformers dir: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
