"""HEAR 2021 runtime: timestamp and scene embeddings by 2.01-s windows
(WavJEPA), or of whole utterances (WavLM, ``RuntimeWavLM``).

Counterpart of ``wavjepa_tpu/api/runtime.py``, with the same window and
padding arithmetic and outputs: every window of a batch is folded into one
batched encoder call. A per-channel (WavJEPA-Nat) model's padding mask is
tiled a channel, channel-major, and its embeddings are averaged over the
channels, so its outputs have the mono model's shapes. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device they raise rather than fall back.

    load_model(ckpt_path, ...) -> RuntimeJEPA
    get_timestamp_embeddings(audio, model) -> (emb (B, S, E), timestamps_ms (B, S))
    get_scene_embeddings(audio, model) -> emb (B, E)

A request is span ``embed.request`` (``utils/profiling.span``, recorded only
while a recording is open; with the runtime's request number), holding
``embed.prepare`` (the host's padding, window fold and masks),
``embed.h2d`` (the copies to the device) and ``embed.encode``
(normalisation, encoder, channel average, cut). Counters ``embed.tokens``
and ``embed.padded_tokens`` count the encoder tokens computed and those
of them that are padding.

``RuntimeWavLM`` serves ``models/wavlm.WavLM`` behind the same interface and
under the same spans and counters: a request's utterances, each normalised
to zero mean and unit variance over its own samples, padded to the
longest, encoded in one batch under the frames' padding mask (``embed.encode``
holds the model's ``wavlm.*`` spans), and a scene embedding the mean of an
utterance's valid frames. ``load_wavlm`` reads a ``transformers``-named
state dict.
"""

from __future__ import annotations

import dataclasses
import itertools
from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch

from wavjepa_tpu_torch.api.convert import (
    detect_pos_embed,
    load_torch_checkpoint,
    state_dict_from_hf_wavlm,
    unwrap_state_dict,
)
from wavjepa_tpu_torch.api.feature_helper import adapt_channels, prepare_batch
from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE, JEPA, JEPAConfig
from wavjepa_tpu_torch.models.wavlm import WavLM, WavLMConfig
from wavjepa_tpu_torch.train.checkpoint import read_model_config
from wavjepa_tpu_torch.utils.profiling import count, span

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to run on the CPU")
    return dev


def chunk_padding(
    cur_frames: int, unit_frames: int, sample_rate: int, output_steps: int
) -> tuple[int, int, int, int]:
    """Window and padding arithmetic → (pad_frames, n_chunks, cut_off,
    total_steps).

    Pads to the next multiple of ``unit_frames`` unconditionally (an exact
    multiple gains a whole padding window), then cuts the output with
    integer window seconds: process_seconds = unit_frames // sample_rate
    (2, not 2.01), output_sr = int(output_steps / 2) (100 Hz), pad_steps
    truncated. A clip of exactly one window yields 200 rows and a fully
    padded second window. Windows shorter than a second use the true float
    rate.
    """
    pad_frames = unit_frames - (cur_frames % unit_frames)
    padded_len = cur_frames + pad_frames
    n_chunks = padded_len // unit_frames
    total_steps = output_steps * n_chunks
    ps_int = unit_frames // sample_rate
    if ps_int >= 1:
        n_chunks_ref = int((padded_len / sample_rate) / ps_int)
        output_sr = int(output_steps / ps_int)
        pad_steps = int(pad_frames / sample_rate * output_sr)
        cut_off = min(output_steps * n_chunks_ref - pad_steps, total_steps)
    else:
        output_sr = output_steps * sample_rate / unit_frames
        pad_steps = int(round(pad_frames / sample_rate * output_sr))
        cut_off = total_steps - pad_steps
    return pad_frames, n_chunks, cut_off, total_steps


class RuntimeJEPA:
    """A JEPA encoder on one device behind the HEAR contract.

    ``state_dict`` holds the port's (reference-named) weights; without it
    the weights are random, drawn from a CPU generator seeded with ``seed``,
    so one seed gives the same weights on every device. ``model`` serves
    modules built elsewhere, as they are (the transformers model of
    ``api/hf_transformers.py``, which holds an ``EncoderPath``'s modules),
    in place of a JEPA built from ``config``. Embeddings are averaged over
    the channels for a per-channel frontend."""

    def __init__(
        self,
        config: JEPAConfig,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device: DeviceLike = None,
        seed: int = 0,
        model: Optional[torch.nn.Module] = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        if model is None:
            model = JEPA(config)
            if state_dict is None:
                model.init_parameters(torch.Generator().manual_seed(seed))
            else:
                # serving needs the encoder side; the predictor may be absent
                missing, unexpected = model.load_state_dict(dict(state_dict), strict=False)
                missing = [k for k in missing if k.startswith(ENCODER_SIDE)]
                if missing or unexpected:
                    raise KeyError(f"state_dict does not fit the model: missing {missing}, "
                                   f"unexpected {unexpected}")
        self.model = model.to(self.device).eval()
        self.sample_rate = config.sample_rate
        self.embedding_size = config.encoder_dim
        self.scene_embedding_size = self.embedding_size
        self.timestamp_embedding_size = self.embedding_size
        self.in_channels = config.in_channels
        self.average_channels = config.extractor == "conv_channel"
        self.unit_frames = config.target_length
        self.output_steps = config.frames_per_window  # a channel's steps a window
        self._requests = itertools.count()

    def _encode(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """chunks (N, C, unit_frames), masks (N, tokens) True = padding, on
        the device → (N, tokens, E) float32, the tokens of the channels
        averaged for a channel-averaging model."""
        # per-window normalisation over (C, T): unbiased variance, std + 1e-5
        mean = x.mean(dim=(-2, -1), keepdim=True)
        n = x.shape[-1] * x.shape[-2]
        var = (x - mean).square().sum(dim=(-2, -1), keepdim=True) / max(n - 1, 1)
        normed = (x - mean) / (var.sqrt() + 1e-5)
        emb = self.model.represent(normed.to(self.config.dtype), m).float()
        if self.average_channels and self.in_channels > 1:
            n_win, _, e = emb.shape
            emb = emb.reshape(n_win, self.in_channels, self.output_steps, e).mean(1)
        return emb

    def _timestamp_embeddings(self, audio) -> tuple[torch.Tensor, torch.Tensor]:
        with span("embed.prepare"):
            batch = self._to_batch(audio)
            b, c, cur_frames = batch.shape
            pad_frames, n_chunks, cut_off, total_steps = chunk_padding(
                cur_frames, self.unit_frames, self.sample_rate, self.output_steps
            )
            padded = np.pad(batch, ((0, 0), (0, 0), (0, pad_frames)))
            step_mask = np.zeros((b, total_steps), bool)
            step_mask[:, cut_off:] = True
            # fold windows into the batch: (B·n, C, unit)
            chunks = padded.reshape(b, c, n_chunks, self.unit_frames).transpose(0, 2, 1, 3)
            chunks = np.ascontiguousarray(chunks.reshape(b * n_chunks, c, self.unit_frames))
            masks = step_mask.reshape(b * n_chunks, self.output_steps)
            if self.in_channels > 1 and self.config.extractor == "conv_channel":
                # a copy of the mask a channel, channel-major, as the tokens
                masks = np.tile(masks[:, None, :], (1, self.in_channels, 1)).reshape(
                    b * n_chunks, -1)
        copies = masks.shape[1] // self.output_steps  # the tokens of a step: a channel's each
        count("embed.tokens", b * total_steps * copies)
        count("embed.padded_tokens", b * (total_steps - cut_off) * copies)
        with torch.inference_mode():
            with span("embed.h2d"):
                x = torch.from_numpy(chunks).to(self.device)
                m = torch.from_numpy(masks).to(self.device)
            with span("embed.encode"):
                emb = self._encode(x, m)
                emb = emb.reshape(b, n_chunks * emb.shape[1], emb.shape[-1])[:, :cut_off]
        # uniform grid over the unpadded duration, in ms
        x_len = emb.shape[1]
        step_ms = cur_frames / self.sample_rate / x_len * 1000.0
        ts = step_ms * torch.arange(x_len, dtype=torch.float64, device=self.device)
        return emb, ts[None, :].expand(b, x_len).contiguous()

    def get_timestamp_embeddings(self, audio) -> tuple[torch.Tensor, torch.Tensor]:
        """audio: list of waveforms, or (B, T)/(B, C, T) array or tensor →
        ((B, S, E) float32, (B, S) float64 timestamps in ms), on the device."""
        with span("embed.request", request=next(self._requests)):
            return self._timestamp_embeddings(audio)

    def get_scene_embeddings(self, audio) -> torch.Tensor:
        with span("embed.request", request=next(self._requests)):
            emb, _ = self._timestamp_embeddings(audio)
            return emb.mean(dim=1)

    def _to_batch(self, audio) -> np.ndarray:
        if isinstance(audio, (list, tuple)):
            return prepare_batch(audio, self.in_channels)
        if isinstance(audio, torch.Tensor):
            arr = audio.detach().cpu().float().numpy()
        else:
            arr = np.asarray(audio, np.float32)
        if arr.ndim in (2, 3):
            return prepare_batch(list(arr), self.in_channels)
        raise ValueError(f"unsupported audio input shape {arr.shape}")


def load_model(
    model_file_path: str = "",
    config: Optional[JEPAConfig] = None,
    in_channels: int = 1,
    process_seconds: Optional[float] = None,
    model_size: str = "base",
    pos_embed: Optional[str] = None,
    device: DeviceLike = None,
    seed: int = 0,
    channel_wise: bool = False,
) -> RuntimeJEPA:
    """HEAR ``load_model``: a runtime from a reference-format torch
    checkpoint (a reference ``.ckpt`` or a port training checkpoint), or
    with random weights from ``seed`` when no path is given.

    The architecture comes from ``config``; else, for a checkpoint, from
    the ``model_config.json`` a training run writes beside it (the JAX
    package's sidecar format), served in bfloat16 without packing, with its
    ``attn_impl`` fields, and with the ``pos_embed`` and ``process_seconds``
    given here winning over its own; else it is
    ``JEPAConfig(size=model_size)`` in bfloat16 with
    ``process_seconds`` windows (2.01 s by default) and, with
    ``channel_wise``, a frontend a channel (WavJEPA-Nat), whose position
    table is detected from the table the checkpoint stores unless
    ``pos_embed`` is given. Orbax directories have no port."""
    extractor = "conv_channel" if channel_wise else "conv"
    dev = resolve_device(device)
    window_s = 2.01 if process_seconds is None else process_seconds
    state_dict = None
    if model_file_path:
        path = Path(model_file_path)
        if path.is_dir():
            raise NotImplementedError("orbax checkpoint directories have no port yet")
        state_dict = unwrap_state_dict(load_torch_checkpoint(str(path)))
        if config is None:
            sidecar = read_model_config(path.parent)
            if sidecar is not None:
                # served as the JAX package serves a sidecar: bf16, no packing
                config = dataclasses.replace(
                    sidecar,
                    pos_embed=pos_embed or sidecar.pos_embed,
                    pack_encoder=None,
                    pack_decoder=None,
                    dtype=torch.bfloat16,
                )
                if process_seconds is not None:
                    config = dataclasses.replace(config, process_seconds=process_seconds)
        if config is None and pos_embed is None:
            probe = JEPAConfig(in_channels=in_channels, extractor=extractor,
                               process_seconds=window_s, size=model_size)
            pos_embed = detect_pos_embed(
                state_dict, probe.encoder_dim, probe.frames_per_window, probe.total_patches
            )
    if config is None:
        config = JEPAConfig(
            in_channels=in_channels,
            extractor=extractor,
            process_seconds=window_s,
            size=model_size,
            pos_embed=pos_embed or "time",
            dtype=torch.bfloat16,
        )
    if state_dict is not None:
        # keep the encoder side: the decoder, teacher and stored tables go
        state_dict = {
            k: v if isinstance(v, torch.Tensor) else torch.tensor(v)
            for k, v in state_dict.items()
            if k.startswith(ENCODER_SIDE)
        }
    return RuntimeJEPA(config, state_dict, dev, seed)


class RuntimeWavLM:
    """WavLM's encoder on one device behind the HEAR contract, serving whole
    utterances: a request's are padded to its longest and encoded as one
    batch. ``state_dict`` holds ``models/wavlm.WavLM``'s weights
    (``api/convert.state_dict_from_hf_wavlm`` maps ``transformers``' names
    onto them); without it the weights are drawn from ``seed``."""

    def __init__(self, config: WavLMConfig = WavLMConfig(),
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.config = config
        model = WavLM(config)
        if state_dict is None:
            model.init_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(dict(state_dict), strict=True)
        self.model = model.to(self.device).eval()
        self.sample_rate = config.sample_rate
        self.embedding_size = config.hidden_size
        self.scene_embedding_size = self.timestamp_embedding_size = self.embedding_size
        self.frame_ms = 1000.0 * float(np.prod(config.conv_stride)) / config.sample_rate
        self._requests = itertools.count()

    def _to_batch(self, audio) -> tuple[np.ndarray, np.ndarray]:
        """Mono utterances → ((B, samples of the longest) float32 zero-padded,
        (B,) int64 samples of each)."""
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().cpu().float().numpy()
        if not isinstance(audio, (list, tuple)):
            audio = np.asarray(audio, np.float32)
            if audio.ndim not in (1, 2):
                raise ValueError(f"unsupported audio input shape {audio.shape}")
            audio = [audio] if audio.ndim == 1 else list(audio)
        waves = [adapt_channels(np.asarray(a, np.float32), 1)[0] for a in audio]
        lengths = np.array([w.shape[-1] for w in waves], np.int64)
        batch = np.zeros((len(waves), int(lengths.max())), np.float32)
        for i, w in enumerate(waves):
            batch[i, :w.shape[-1]] = w
        return batch, lengths

    def _normalize(self, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """Each row to zero mean and unit variance over its first n samples
        (biased variance, + 1e-7 under the root), zero past them."""
        valid = (torch.arange(x.shape[1], device=x.device)[None, :] < n[:, None]).float()
        count = n[:, None].float()
        mean = (x * valid).sum(1, keepdim=True) / count
        var = ((x - mean) * valid).square().sum(1, keepdim=True) / count
        return (x - mean) * torch.rsqrt(var + 1e-7) * valid

    def _embed(self, audio, scene: bool):
        """(B, T, E) float32 frames and the (B, T) padding mask, or with
        ``scene`` (B, E), each utterance's mean over its valid frames."""
        with span("embed.prepare"):
            batch, lengths = self._to_batch(audio)
            frames = self.config.frames(batch.shape[1])
            valid = sum(self.config.frames(int(n)) for n in lengths)
        count("embed.tokens", len(lengths) * frames)
        count("embed.padded_tokens", len(lengths) * frames - valid)
        with torch.inference_mode():
            with span("embed.h2d"):
                x = torch.from_numpy(batch).to(self.device)
                n = torch.from_numpy(lengths).to(self.device)
            with span("embed.encode"):
                if self.config.do_normalize:
                    x = self._normalize(x, n)
                emb, mask = self.model(x, n)
                if scene:
                    keep = (~mask)[..., None].float()
                    return (emb * keep).sum(1) / keep.sum(1), mask
        return emb, mask

    def get_timestamp_embeddings(self, audio) -> tuple[torch.Tensor, torch.Tensor]:
        """Utterances (a list of waveforms, or a (B, T) array or tensor) →
        ((B, S, E) float32 frames, padded past each utterance's end,
        (B, S) float64 timestamps in ms), on the device."""
        with span("embed.request", request=next(self._requests)):
            emb, _ = self._embed(audio, scene=False)
            ts = self.frame_ms * torch.arange(emb.shape[1], dtype=torch.float64,
                                              device=self.device)
            return emb, ts[None, :].expand(emb.shape[0], -1).contiguous()

    def get_scene_embeddings(self, audio) -> torch.Tensor:
        with span("embed.request", request=next(self._requests)):
            return self._embed(audio, scene=True)[0]

    def valid_frames(self, audio) -> list[int]:
        """Each utterance's frames that its scene embedding averages: those
        the model's padding mask leaves in a request of ``audio``."""
        batch, lengths = self._to_batch(audio)
        mask = self.model.padding_mask(torch.from_numpy(lengths),
                                       self.config.frames(batch.shape[1]))
        return (~mask).sum(1).tolist()


def load_wavlm(model_file_path: str = "", config: Optional[WavLMConfig] = None,
               device: DeviceLike = None, seed: int = 0) -> RuntimeWavLM:
    """A WavLM runtime from a ``transformers``-named state dict (a
    ``pytorch_model.bin``-style file, the encoder's or a task model's under
    ``wavlm.``), or with weights drawn from ``seed`` when no path is given;
    WavLM Large's configuration, in bfloat16, unless ``config`` is given."""
    state_dict = None
    if model_file_path:
        state_dict = state_dict_from_hf_wavlm(
            unwrap_state_dict(load_torch_checkpoint(model_file_path)))
    return RuntimeWavLM(config or WavLMConfig(), state_dict, device, seed)


def get_timestamp_embeddings(audio, model: RuntimeJEPA):
    return model.get_timestamp_embeddings(audio)


def get_scene_embeddings(audio, model: RuntimeJEPA):
    return model.get_scene_embeddings(audio)
