"""The host side of scene training (WavJEPA-Nat, and the denoiser to come):
clean 32-kHz clips joined with RIR and noise side channels into fixed-shape
sample dicts; the scenes themselves are built on the device in the step
(``ops/scenes.py``).

Counterpart of ``wavjepa_tpu/data/denoise_pipeline.py``, with its seeding,
on the port's ``shards``, ``decode`` and ``pipeline``: the clean clips come
from a ``ShardAudioSource``; RIR stacks and noise from ``NpySideSource``
(.npy tar shards, a streaming shuffle, ``spawn`` worker processes on the
audio source's scaffolding, ``pipeline.WorkerSource``). Every array has a
fixed shape: RIRs padded or cut to ``rir_seconds``, the noise-RIR count
padded with zero rows to ``max_noise_sources`` (a zero RIR adds nothing),
noise shipped placed in a clip-length buffer.

Optional device banks replace the per-clip payload: ``rir_bank_size``
stacks (and ``noise_bank_size`` faded noise rows) go to the device once
(``scene_bank``); samples then carry ``rir_index`` (``noise_index`` and
``noise_start``), and ``next_bank_refresh`` streams fresh rows into ring
slots. ``denoise_batches`` attaches a batch's refresh after drawing its
samples; the train loop writes it into the device bank after the step that
consumed the batch, so every clip of a batch reads the rows (and the active
noise lengths) its draws saw.

No torch here: every spawned worker imports this module afresh.
"""

from __future__ import annotations

import os
import traceback
from typing import Iterator, Optional, Sequence

import numpy as np

from wavjepa_tpu_torch.data.decode import decode_audio
from wavjepa_tpu_torch.data.pipeline import (
    ShardAudioSource,
    WorkerError,
    WorkerSource,
    _put,
    quantize_clip_int16,
)
from wavjepa_tpu_torch.data.shards import expand_shard_pattern, iter_shard_samples


def _npy_side_worker(shards, seed, shuffle_buffer, out_queue, stop_event):
    """A side channel's worker body (top level, so that ``spawn`` can pickle
    it): .npy samples from the repeating shard stream through a streaming
    shuffle of ``shuffle_buffer`` onto the queue."""
    parent = os.getppid()
    try:
        rng = np.random.default_rng(seed)
        buf: list[np.ndarray] = []
        for key, sample in iter_shard_samples(list(shards), repeat=True):
            if stop_event.is_set():
                return
            try:
                arr, _ = decode_audio(sample)
            except Exception as exc:  # warn and continue, as WebDataset does
                print(f"[data] skipping npy sample {key}: {exc}", flush=True)
                continue
            if len(buf) < shuffle_buffer:
                buf.append(arr)
                continue
            j = int(rng.integers(len(buf)))  # emit a random slot, refill it
            item, buf[j] = buf[j], arr
            if not _put(out_queue, stop_event, item, parent):
                return
    except Exception:  # reported to the consumer, which raises it
        _put(out_queue, stop_event, WorkerError(traceback.format_exc()), parent)


class NpySideSource(WorkerSource):
    """An endless stream of arrays from .npy tar shards (RIR stacks, noise),
    from ``num_workers`` worker processes (or threads) (``WorkerSource``),
    each over its stripe of the shards with its own seed."""

    def __init__(self, pattern: str, num_workers: int = 1, queue_size: int = 500,
                 shuffle_buffer: int = 100, seed: int = 0, backend: str = "process"):
        super().__init__(backend, queue_size)
        self.shards = expand_shard_pattern(pattern)
        n = max(1, num_workers)
        for wid in range(n):
            self._add_worker(_npy_side_worker,
                             (self.shards[wid::n] or self.shards, seed + wid, shuffle_buffer))


def fade_noise(noise: np.ndarray, audio_len: int, sr: int, rng: np.random.Generator,
               fade_seconds: float = 0.2) -> np.ndarray:
    """Noise longer than the clip: a random crop of the clip's length with a
    fade-out; otherwise a fade-in and a fade-out (ramps of ``fade_seconds``)."""
    n = int(sr * fade_seconds)
    noise = noise.astype(np.float32)
    if noise.shape[-1] > audio_len:
        start = int(rng.integers(0, noise.shape[-1] - audio_len))
        noise = noise[..., start:start + audio_len].copy()
        ramp_out = np.linspace(1.0, 0.0, min(n, noise.shape[-1]), dtype=np.float32)
        noise[..., -ramp_out.size:] *= ramp_out
    else:
        noise = noise.copy()
        ramp_in = np.linspace(0.0, 1.0, min(n, noise.shape[-1]), dtype=np.float32)
        ramp_out = ramp_in[::-1]
        noise[..., :ramp_in.size] *= ramp_in
        noise[..., -ramp_out.size:] *= ramp_out
    return noise


def _rms_normalize(wav: np.ndarray, target_dbfs: float = -14.0) -> np.ndarray:
    rms = float(np.sqrt(np.mean(np.square(wav))))
    if rms > 0:
        wav = wav * 10.0 ** ((target_dbfs - 20.0 * np.log10(rms)) / 20.0)
    return wav.astype(np.float32)


def _pad_or_trim(arr: np.ndarray, length: int) -> np.ndarray:
    t = arr.shape[-1]
    if t >= length:
        return arr[..., :length]
    return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, length - t)])


class DenoiseSampleSource:
    """Clean clips joined with the RIR and noise side channels: an iterator
    of fixed-shape sample dicts (``audio``; ``source_rir``/``noise_rirs``
    or ``rir_index``; ``noise`` or ``noise_index``; ``noise_start``,
    ``noise_length``, ``snr``). ``transfer_dtype="int16"`` quantizes the
    audio and the noise per row (the gains cancel on the device); the bank
    options are in the module docstring. ``num_workers=0`` loads every
    stream on one thread of this process."""

    def __init__(
        self,
        data_pattern: str | Sequence[str],
        rir_pattern: Optional[str] = None,
        noise_pattern: Optional[str] = None,
        sr: int = 32000,
        target_seconds: float = 10.0,
        snr_low: float = -5.0,
        snr_high: float = 5.0,
        max_noise_sources: int = 5,
        rir_seconds: float = 2.0,
        num_workers: int = 16,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        transfer_dtype: str = "float32",  # "float32" | "int16"
        rir_bank_size: int = 0,  # 0 = RIRs inline with every sample
        noise_bank_size: int = 0,  # 0 = the placed noise inline
    ):
        self.sr = sr
        self.clip_len = int(sr * target_seconds)
        self.rir_len = int(sr * rir_seconds)
        self.max_noise = max_noise_sources
        self.snr_low, self.snr_high = snr_low, snr_high
        self.with_rir = rir_pattern is not None
        self.with_noise = noise_pattern is not None
        self.transfer_dtype = transfer_dtype
        self.rng = np.random.default_rng(seed + 7919 * host_id)
        backend = "process" if num_workers > 0 else "thread"
        # 4 RIR workers and 1 noise worker, as the JAX package; one thread
        # each when everything loads in-process
        side = (4, 1) if num_workers > 0 else (1, 1)
        self.audio = self.rirs = self.noise = None
        try:
            self.audio = ShardAudioSource(
                data_pattern, target_sr=sr, target_seconds=target_seconds,
                num_workers=num_workers, host_id=host_id, num_hosts=num_hosts, seed=seed,
                backend=backend,
            ).start()
            if self.with_rir:
                self.rirs = NpySideSource(rir_pattern, num_workers=side[0], seed=seed + 1,
                                          backend=backend).start()
            if self.with_noise:
                self.noise = NpySideSource(noise_pattern, num_workers=side[1], seed=seed + 2,
                                           backend=backend).start()
            self._bank: Optional[dict[str, np.ndarray]] = None
            self._bank_ptr = 0
            if self.with_rir and rir_bank_size > 0:
                self._build_bank(rir_bank_size)
            self._noise_bank: Optional[np.ndarray] = None
            self._noise_row_len: Optional[np.ndarray] = None
            self._noise_ptr = 0
            if self.with_noise and noise_bank_size > 0:
                self._build_noise_bank(noise_bank_size)
        except BaseException:
            self.stop()
            raise

    def _prep_rir(self, rir: np.ndarray) -> np.ndarray:
        """(C, L) or (L,) → (C, rir_len) f32."""
        if rir.ndim == 1:
            rir = rir[None, :]
        return _pad_or_trim(rir.astype(np.float32), self.rir_len)

    def _stack_rows(self, rir_stack: np.ndarray) -> tuple:
        """One side-channel stack (the source's RIR, then the noise
        sources') → (source (C, rir_len), noise (max_noise, C, rir_len))."""
        if rir_stack.ndim == 2:
            rir_stack = rir_stack[:, None, :]
        src = self._prep_rir(rir_stack[0])
        c = src.shape[0]
        nr = rir_stack[1:1 + self.max_noise]
        nr = (np.stack([self._prep_rir(r) for r in nr]) if len(nr)
              else np.zeros((0, c, self.rir_len), np.float32))
        pad = self.max_noise - nr.shape[0]
        if pad > 0:
            nr = np.concatenate([nr, np.zeros((pad,) + nr.shape[1:], np.float32)])
        return src, nr

    def _build_bank(self, n: int) -> None:
        srcs, noises = zip(*(self._stack_rows(next(self.rirs)) for _ in range(n)))
        self._bank = {"source_rir": np.stack(srcs)}
        if self.with_noise:
            self._bank["noise_rirs"] = np.stack(noises)

    def _faded_noise_row(self) -> tuple[np.ndarray, int]:
        """One noise sample through the inline path's fade → (the row
        zero-padded to clip_len, its active length)."""
        faded = fade_noise(_rms_normalize(np.ravel(next(self.noise))), self.clip_len,
                           self.sr, self.rng)
        n_len = min(faded.shape[-1], self.clip_len)
        row = np.zeros((self.clip_len,), np.float32)
        row[:n_len] = faded[:n_len]
        if self.transfer_dtype == "int16":
            row = quantize_clip_int16(row)
        return row, n_len

    def _build_noise_bank(self, n: int) -> None:
        rows, lens = zip(*(self._faded_noise_row() for _ in range(n)))
        self._noise_bank = np.stack(rows)
        self._noise_row_len = np.asarray(lens, np.int64)

    def scene_bank(self) -> Optional[dict[str, np.ndarray]]:
        """The host copy of the device bank as first built ({"source_rir":
        (N, C, L)[, "noise_rirs": (N, M, C, L)][, "noise": (Nn, clip_len)]}),
        or None: send it to the device once."""
        bank = dict(self._bank) if self._bank is not None else {}
        if self._noise_bank is not None:
            bank["noise"] = self._noise_bank
        return bank or None

    def next_bank_refresh(self, k: int) -> dict[str, dict[str, np.ndarray]]:
        """k fresh rows for each bank, in ring order: {"slots": {key: (k,)
        int32}, "rows": {key: (k, ...)}} for ``ops/scenes.update_rir_bank``.
        Only the slot pointers and the noise rows' active lengths are kept
        here, so draws made after this call see the new lengths."""
        slots: dict[str, np.ndarray] = {}
        rows: dict[str, np.ndarray] = {}
        if self._bank is not None:
            n = self._bank["source_rir"].shape[0]
            rir_slots, srcs, noises = [], [], []
            for _ in range(k):
                src, nr = self._stack_rows(next(self.rirs))
                rir_slots.append(self._bank_ptr)
                self._bank_ptr = (self._bank_ptr + 1) % n
                srcs.append(src)
                noises.append(nr)
            slots["source_rir"] = np.asarray(rir_slots, np.int32)
            rows["source_rir"] = np.stack(srcs)
            if self.with_noise:
                slots["noise_rirs"] = slots["source_rir"]
                rows["noise_rirs"] = np.stack(noises)
        if self._noise_bank is not None:
            nn = self._noise_bank.shape[0]
            n_slots, n_rows = [], []
            for _ in range(k):
                row, n_len = self._faded_noise_row()
                n_slots.append(self._noise_ptr)
                self._noise_row_len[self._noise_ptr] = n_len
                self._noise_ptr = (self._noise_ptr + 1) % nn
                n_rows.append(row)
            slots["noise"] = np.asarray(n_slots, np.int32)
            rows["noise"] = np.stack(n_rows)
        return {"slots": slots, "rows": rows}

    def stop(self) -> None:
        """Stop every stream's workers."""
        for source in (self.audio, self.rirs, self.noise):
            if source is not None:
                source.stop()

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        wire16 = self.transfer_dtype == "int16"
        for clip in self.audio:  # (1, clip_len) f32 at −14 dBFS
            audio = clip[0].astype(np.float32)
            sample: dict[str, np.ndarray] = {
                "audio": quantize_clip_int16(audio) if wire16 else audio}
            if self.with_rir:
                if self._bank is not None:
                    sample["rir_index"] = np.int32(
                        self.rng.integers(self._bank["source_rir"].shape[0]))
                else:
                    src, nr = self._stack_rows(next(self.rirs))
                    sample["source_rir"] = src
                    if self.with_noise:
                        sample["noise_rirs"] = nr
            if self.with_noise:
                if self._noise_bank is not None:
                    j = int(self.rng.integers(self._noise_bank.shape[0]))
                    n_len = int(self._noise_row_len[j])
                    start = (int(self.rng.integers(0, self.clip_len - n_len))
                             if self.clip_len > n_len else 0)
                    sample["noise_index"] = np.int32(j)
                else:
                    faded = fade_noise(_rms_normalize(np.ravel(next(self.noise))),
                                       self.clip_len, self.sr, self.rng)
                    n_len = min(faded.shape[-1], self.clip_len)
                    start = 0
                    placed = np.zeros((self.clip_len,), np.float32)
                    if self.clip_len > n_len:
                        start = int(self.rng.integers(0, self.clip_len - n_len))
                    placed[start:start + n_len] = faded[:n_len]
                    sample["noise"] = quantize_clip_int16(placed) if wire16 else placed
                sample["noise_start"] = np.int32(start)
                sample["noise_length"] = np.int32(n_len)
                sample["snr"] = np.float32(self.rng.uniform(self.snr_low, self.snr_high))
            yield sample


def denoise_batches(source: DenoiseSampleSource, batch_size: int,
                    refresh_rirs_per_batch: int = 0) -> Iterator[dict[str, np.ndarray]]:
    """Sample dicts stacked into batch dicts. With a bank and
    ``refresh_rirs_per_batch > 0`` each batch also carries
    ``rir_bank_refresh``, drawn after the batch's samples: the train loop
    applies it after the step that consumes the batch."""
    it = iter(source)
    while True:
        samples = [next(it) for _ in range(batch_size)]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        if refresh_rirs_per_batch > 0 and source.scene_bank() is not None:
            batch["rir_bank_refresh"] = source.next_bank_refresh(refresh_rirs_per_batch)
        yield batch
