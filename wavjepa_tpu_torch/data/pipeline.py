"""The host side of training input: tar shards → decoded, mono, resampled,
level-normalized 10-s clips → shuffled batches.

Counterpart of ``wavjepa_tpu/data/pipeline.py``, with its seeding, so that
the same shards, seed and thread backend give the same clips. Each worker
decodes (``data/decode.py``), keeps the first channel, resamples to the
target rate (``data/resample.py``), normalizes to −14 dBFS RMS, pads or trims
to 10 s and, on the int16 wire, quantizes; masks are drawn on the device in
the train step, not here. Workers are processes started with ``spawn`` (the
trainer has initialised CUDA and started threads, which ``fork`` would copy
half-way), or threads for tests and small runs. Several shard lists mix by
giving each source a share of the workers in proportion to
``mixing_weights``, each source striped over its own workers.

No module of ``wavjepa_tpu_torch.data`` imports torch: every spawned worker
imports this module afresh, and sixteen of them need not each load torch.
A worker that fails puts a ``WorkerError`` on the queue, which the consumer
raises; a sample that does not decode is skipped with a warning.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
import traceback
from typing import Iterator, Optional, Sequence

import numpy as np

from wavjepa_tpu_torch.data.decode import decode_audio
from wavjepa_tpu_torch.data.resample import resample_np
from wavjepa_tpu_torch.data.shards import expand_shard_pattern, iter_shard_samples, split_shards
from wavjepa_tpu_torch.parallel.layout import data_group, process_group  # noqa: F401


def preprocess_clip(wav: np.ndarray, target_sr: int, target_seconds: float = 10.0,
                    target_dbfs: float = -14.0) -> np.ndarray:
    """RMS-normalize to −14 dBFS, then zero-pad or trim to 10 s."""
    rms = float(np.sqrt(np.mean(np.square(wav))))
    if rms > 0:
        wav = wav * 10.0 ** ((target_dbfs - 20.0 * np.log10(rms)) / 20.0)
    target_len = int(target_sr * target_seconds)
    t = wav.shape[-1]
    if t < target_len:
        wav = np.pad(wav, ((0, 0), (0, target_len - t)))
    elif t > target_len:
        wav = wav[:, :target_len]
    return wav.astype(np.float32)


def quantize_clip_int16(clip: np.ndarray) -> np.ndarray:
    """Peak-normalize a preprocessed clip and quantize it to int16, the
    host-to-device wire (half the bytes of bf16, a quarter of f32). The
    train step instance-normalizes every crop over (C, T), which removes any
    per-clip gain, so only the quantization noise at −96 dBFS remains
    (``ops/audio.py`` dequantizes)."""
    peak = float(np.max(np.abs(clip))) if clip.size else 0.0
    if peak <= 0:
        return np.zeros(clip.shape, np.int16)
    return np.round(clip * (32767.0 / peak)).astype(np.int16)


class WorkerError:
    """Put on the queue in place of a clip by a worker that failed."""

    def __init__(self, text: str):
        self.text = text


def _put(out_queue, stop_event, item, parent: int) -> bool:
    """Put ``item``, waiting while the queue is full; False once the source
    is stopped or the process that started this worker has gone (an
    orphaned worker would otherwise wait for ever)."""
    while not stop_event.is_set() and os.getppid() == parent:
        try:
            out_queue.put(item, timeout=1.0)
            return True
        except queue.Full:
            continue
    return False


def _audio_worker(shards, target_sr, target_seconds, seed, transfer_dtype, out_queue,
                  stop_event):
    """A worker's body (top level, so that ``spawn`` can pickle it): decode →
    first channel → resample → normalize → pad or trim → queue, over its
    shards in an order shuffled by ``seed``, forever."""
    parent = os.getppid()
    try:
        from wavjepa_tpu_torch.data._native.build import load

        load()  # a library that will not build fails the worker, not each sample
        rng = np.random.default_rng(seed)
        shards = list(shards)
        rng.shuffle(shards)
        for key, sample in iter_shard_samples(shards, repeat=True):
            if stop_event.is_set():
                return
            try:
                wav, sr_in = decode_audio(sample)
                wav = wav[:1]  # mono: the first channel, as the reference takes audio[0]
                if sr_in is not None and sr_in != target_sr:
                    wav = resample_np(wav, sr_in, target_sr)
                clip = preprocess_clip(wav, target_sr, target_seconds)
                if transfer_dtype == "int16":
                    clip = quantize_clip_int16(clip)
            except Exception as exc:  # warn and continue, as WebDataset does
                print(f"[data] skipping sample {key}: {exc}", flush=True)
                continue
            if not _put(out_queue, stop_event, clip, parent):
                return
    except Exception:  # reported to the consumer, which raises it
        _put(out_queue, stop_event, WorkerError(traceback.format_exc()), parent)


class WorkerSource:
    """Items that worker processes (started with ``spawn``) or threads put
    on one bounded queue. A subclass adds each worker's body and arguments
    with ``_add_worker``; the body takes the queue and the stop event after
    them. ``start()`` starts the workers; ``next()`` gives an item, raising
    a worker's ``WorkerError`` or when every worker has exited; ``stop()``
    stops and joins them. Also a context manager."""

    def __init__(self, backend: str, queue_size: int):
        if backend not in ("process", "thread"):
            raise ValueError(f"backend must be 'process' or 'thread', got {backend!r}")
        self.backend = backend
        if backend == "process":
            self._ctx = mp.get_context("spawn")
            self.queue = self._ctx.Queue(maxsize=queue_size)
            self._stop = self._ctx.Event()
        else:
            self.queue = queue.Queue(maxsize=queue_size)
            self._stop = threading.Event()
        self.queue_size = queue_size
        self._workers: list = []

    def _add_worker(self, target, args: tuple) -> None:
        args = (*args, self.queue, self._stop)
        if self.backend == "process":
            worker = self._ctx.Process(target=target, args=args, daemon=True)
        else:
            worker = threading.Thread(target=target, args=args, daemon=True)
        self._workers.append(worker)

    def start(self):
        for worker in self._workers:
            worker.start()
        return self

    def alive(self) -> int:
        """Workers still running."""
        return sum(w.is_alive() for w in self._workers)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the workers and wait for them. A process exits only once
        what it put has left its pipe, so the queue is read meanwhile, with
        a blocking get: a reader that gave up at the first empty moment
        would leave the writers waiting on it. A process still alive after
        ``timeout`` seconds is terminated, and the queue, which it may have
        left half-written, is closed unread."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        alive = [w for w in self._workers if w.is_alive()]
        while alive and time.monotonic() < deadline:
            try:
                self.queue.get(timeout=0.05)
            except queue.Empty:
                pass
            alive = [w for w in alive if w.is_alive()]
        if self.backend == "process":
            for worker in alive:
                worker.terminate()
            for worker in alive:
                worker.join(timeout=1.0)
            self.queue.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __iter__(self):
        return self

    def __next__(self):
        # a bounded get, so that stop() and dead workers are seen
        while not self._stop.is_set():
            try:
                item = self.queue.get(timeout=1.0)
            except queue.Empty:
                if not self._stop.is_set() and not self.alive():
                    raise RuntimeError("every data worker has exited") from None
                continue
            if isinstance(item, WorkerError):
                raise RuntimeError(f"a data worker failed:\n{item.text}")
            return item
        raise StopIteration


class ShardAudioSource(WorkerSource):
    """Clips from tar shards, produced by worker processes (or threads)
    (``WorkerSource``). ``start()`` builds the native library in this
    process (so that a failed build raises here), then starts the workers."""

    def __init__(
        self,
        patterns: Sequence[str] | str,
        target_sr: int = 16000,
        target_seconds: float = 10.0,
        mixing_weights: Optional[Sequence[float]] = None,
        num_workers: int = 16,
        queue_size: int = 512,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        backend: str = "process",  # "process" | "thread"
        transfer_dtype: str = "float32",  # "float32" | "int16"
    ):
        super().__init__(backend, queue_size)
        if isinstance(patterns, str):
            patterns = [patterns]
        self.sources = [expand_shard_pattern(p) for p in patterns]
        self.num_workers = max(1, num_workers)

        if mixing_weights is None:
            mixing_weights = [1.0] * len(self.sources)
        w = np.asarray(mixing_weights, np.float64)
        counts = np.maximum(1, np.round(w / w.sum() * self.num_workers).astype(int))
        self.worker_shards: list[list[str]] = []
        for src_idx, n in enumerate(counts):
            for k in range(int(n)):
                # each source striped over its own n workers: striping by the
                # global worker id would leave shards of every source unread
                shards = split_shards(self.sources[src_idx], host_id, num_hosts, k, int(n)
                                      ) or list(self.sources[src_idx])
                self._add_worker(_audio_worker, (shards, target_sr, target_seconds,
                                                 seed + len(self._workers), transfer_dtype))
                self.worker_shards.append(shards)

    def start(self) -> "ShardAudioSource":
        from wavjepa_tpu_torch.data._native.build import load

        load()
        return super().start()


def shuffled_batches(sample_iter: Iterator[np.ndarray], batch_size: int,
                     shuffle_buffer: int = 1000, seed: int = 0) -> Iterator[np.ndarray]:
    """WebDataset's streaming shuffle: a buffer of ``shuffle_buffer``
    samples, from which each batch element is a uniformly random eviction
    replaced by the next sample. Ends when the samples end."""
    rng = np.random.default_rng(seed)
    it = iter(sample_iter)
    try:
        buf = [next(it) for _ in range(shuffle_buffer)]
        while True:
            batch = []
            for _ in range(batch_size):
                j = int(rng.integers(len(buf)))
                batch.append(buf[j])
                buf[j] = next(it)
            yield np.stack(batch)
    except StopIteration:
        return


class ShardBatches:
    """The batches of a started source (a ``ShardAudioSource``, or a scene
    source of ``data/denoise_pipeline.py``); ``stop()`` stops its workers
    (the train loop calls it when training ends or raises)."""

    def __init__(self, source: ShardAudioSource, batches: Iterator[np.ndarray]):
        self.source = source
        self._batches = batches

    def __iter__(self) -> "ShardBatches":
        return self

    def __next__(self) -> np.ndarray:
        return next(self._batches)

    def stop(self) -> None:
        self.source.stop()


def rank_batch_size(batch_size: int, world: int) -> int:
    """A rank's share of the global batch of ``batch_size`` clips; raises
    where ``world`` ranks do not divide it."""
    if batch_size % world:
        raise ValueError(f"trainer.batch_size={batch_size} does not split over {world} "
                         f"data-parallel ranks")
    return batch_size // world


def audio_shard_batches(cfg) -> ShardBatches:
    """The configured input pipeline, started: (B, 1, sr·10) batches, f32
    or int16 (``data.transfer_dtype``), from ``data.num_workers`` worker
    processes, or from one thread of this process at ``num_workers=0`` (as
    torch's DataLoader loads in-process at 0). Shards are striped over the
    ranks of the torch.distributed process group when one is initialised,
    and each rank batches its share of ``trainer.batch_size``; under
    tensor parallelism the shards and the share are a data-parallel rank's
    (``parallel/layout.data_group``), the same for every rank of one
    tensor-parallel group."""
    host_id, num_hosts = data_group()
    batch = rank_batch_size(cfg.trainer.batch_size, num_hosts)
    source = ShardAudioSource(
        cfg.data.data_dirs,
        target_sr=cfg.data.sr,
        target_seconds=cfg.data.target_seconds,
        mixing_weights=cfg.data.mixing_weights,
        num_workers=cfg.data.num_workers,
        host_id=host_id,
        num_hosts=num_hosts,
        seed=cfg.trainer.seed,
        backend="process" if cfg.data.num_workers > 0 else "thread",
        transfer_dtype=cfg.data.transfer_dtype,
    ).start()
    return ShardBatches(source, shuffled_batches(iter(source), batch,
                                                 shuffle_buffer=cfg.data.shuffle_buffer,
                                                 seed=cfg.trainer.seed))
