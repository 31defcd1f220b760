"""JEPA pretraining: state set-up or resume, the step loop with a
threaded host-to-device prefetch, checkpoints and metrics. The loop itself
(``open_run``, ``run_loop``, ``run_step``) also runs denoise distillation
(``train/denoise_loop.py``).

Counterpart of ``wavjepa_tpu/train/loop.py``. Every step draws its crops
and masks from a generator on the device seeded from (seed, step), so a
step depends on the run's seed and its index only, as the JAX package folds
the step into its key; resuming from a checkpoint therefore repeats the
steps an uninterrupted run would have taken, on the synthetic source.

Under torchrun (``parallel/mesh.py``) each process is a data-parallel rank
on ``cuda:LOCAL_RANK`` (gloo ranks on the CPU with ``--device cpu``):
``trainer.batch_size`` is the global batch, of which each rank takes its
rows (the synthetic source's) or batches its share (a shard pipeline, its
shards striped over the ranks); the initial weights are rank 0's; rank 0
alone writes ``model_config.json``, the metrics and the checkpoints, and
every rank waits for each checkpoint and restores from the same file.
With ``trainer.model_parallel`` = mp the ranks are laid out as (data,
model) (``parallel/mesh.init_layout``): each group of mp ranks holds one
replica of the model, a rank its shard of the blocks (the whole model is
seeded, broadcast from rank 0, then cut), the data-parallel rank chooses
the rows and shards, and every batch (and a scene source's bank) is made
the same on the ranks of a group by a broadcast from its first rank. The shard source (``data.data_dirs``) is a shuffled
stream with no position: a resumed run starts it afresh and does not skip
the batches it has already taken, as in the JAX package.

WavJEPA-Nat (``data.nat_scenes``) trains on scene batches (dicts: clean
clips, RIRs, noise, SNRs) that the step turns into binaural or ambisonic
scenes. From shards with device banks, the host bank goes to the device
once, and each batch's ``rir_bank_refresh`` is written into it after the
step that consumed the batch (``run_step``): the JAX package writes it
before, so a clip drawn for a slot that its own batch refreshes reads the
new row with the old row's noise placement. Each rank's bank is its own,
drawn from its own shards, and its batches index it.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from wavjepa_tpu_torch.api.runtime import DeviceLike, resolve_device
from wavjepa_tpu_torch.data.denoise_pipeline import DenoiseSampleSource
from wavjepa_tpu_torch.data.pipeline import ShardBatches, audio_shard_batches
from wavjepa_tpu_torch.data.synthetic import synthetic_audio_batches
from wavjepa_tpu_torch.models.jepa import JEPA
from wavjepa_tpu_torch.ops.scenes import update_rir_bank
from wavjepa_tpu_torch.parallel.mesh import (
    from_rank_zero,
    init_layout,
    initialize_multihost,
    process_group,
    replicated,
    same_over_model_group,
    shard_batch,
    sharded,
)
from wavjepa_tpu_torch.train.checkpoint import CheckpointManager, write_model_config
from wavjepa_tpu_torch.train.config import Config
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import NatSceneConfig, make_jepa_train_step, make_optimizer
from wavjepa_tpu_torch.utils.metrics import MetricLogger, Throughput
from wavjepa_tpu_torch.utils.profiling import span


def build_data_iterator(cfg: Config, start_step: int = 0) -> Iterator:
    """The run's batches: synthetic clips from batch ``start_step`` on when
    ``data.synthetic`` is set or ``data.data_dirs`` is empty, else the shard
    pipeline, started (``data/pipeline.py``; it has no position, so
    ``start_step`` does not apply; ``stop()`` stops its workers). With
    ``data.nat_scenes``, scene batches (``build_denoise_data_iterator``).
    Each data-parallel rank is given its rows of the global batch."""
    if cfg.data.nat_scenes:
        from wavjepa_tpu_torch.train.denoise_loop import build_denoise_data_iterator

        return build_denoise_data_iterator(cfg)
    if cfg.data.synthetic or not cfg.data.data_dirs:
        return map(shard_batch, synthetic_audio_batches(
            cfg.trainer.batch_size, in_channels=cfg.data.in_channels,
            seconds=cfg.data.target_seconds, sr=cfg.data.sr, seed=cfg.trainer.seed,
            start_batch=start_step,
        ))
    return audio_shard_batches(cfg)


def _to_device(batch, device: torch.device):
    """A host batch (an array, or a dict of them, nested for a bank
    refresh) → device tensors, through pinned memory on a card."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    x = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x


def prefetch_to_device(iterator: Iterator, device: torch.device,
                       size: int = 2) -> Iterator:
    """Host batches → device tensors, ``size`` ahead, from a background
    thread: each batch (an array or a dict of arrays) is copied into pinned
    memory and sent with ``non_blocking`` while the current step runs
    (span ``train.h2d``, on that thread); the consumer's wait for a batch
    is span ``train.data_wait``. Closing the generator stops the thread."""
    buf: queue.Queue = queue.Queue(maxsize=max(1, size))
    done = object()
    errors: list = []
    stop = threading.Event()

    def put(item) -> bool:  # gives up once the consumer has gone
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                with span("train.h2d"):
                    batch = _to_device(batch, device)
                if not put(batch):
                    return
        except BaseException as exc:  # re-raised on the consumer's side
            errors.append(exc)
        finally:
            put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with span("train.data_wait"):
                item = buf.get()
            if item is done:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        while not buf.empty():  # free a producer blocked on a full queue
            try:
                buf.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step: a function of (seed, step) only."""
    return (seed * 1_000_003 + step) % (2**63)


def scene_config(cfg: Config) -> Optional[NatSceneConfig]:
    """The step's scene synthesis for a Nat run (``data.nat_scenes``), with
    what its batches carry; None otherwise."""
    if not cfg.data.nat_scenes:
        return None
    from wavjepa_tpu_torch.train.denoise_loop import effective_scene_flags

    with_rir, with_noise = effective_scene_flags(cfg)
    return NatSceneConfig(with_rir=with_rir, with_noise=with_noise,
                          n_channels=cfg.data.in_channels)


def run_step(step_fn, state, batch, generator: torch.Generator,
             rir_bank: Optional[dict] = None):
    """One step on a batch. A scene batch's ``rir_bank_refresh`` is written
    into ``rir_bank`` after the step, which reads the bank as the batch's
    draws saw it (the refresh's rows are for the batches drawn after it)."""
    refresh = batch.pop("rir_bank_refresh", None) if isinstance(batch, dict) else None
    state, metrics = step_fn(state, batch, generator, rir_bank)
    if refresh is not None:
        update_rir_bank(rir_bank, refresh["slots"], refresh["rows"])
    return state, metrics


def device_scene_bank(data_iter, device: torch.device) -> Optional[dict]:
    """The host bank of a scene source with banks (a ``ShardBatches`` over
    a ``DenoiseSampleSource``, as ``build_denoise_data_iterator`` gives),
    sent to ``device`` once; None for any other source."""
    if not (isinstance(data_iter, ShardBatches)
            and isinstance(data_iter.source, DenoiseSampleSource)):
        return None
    bank = data_iter.source.scene_bank()
    return None if bank is None else {k: torch.from_numpy(v).to(device)
                                      for k, v in bank.items()}


def join_run(cfg: Config, device: DeviceLike = None) -> torch.device:
    """This process's device for a run (``cuda:LOCAL_RANK`` under torchrun),
    in the run's process group where it was launched into one
    (``initialize_multihost``). A process alone with several cards visible
    and ``trainer.num_devices=0`` trains on one of them, and says so."""
    dev = initialize_multihost(device=resolve_device(device))
    n_visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cfg.trainer.num_devices == 0 and n_visible > 1 and not dist.is_initialized():
        print(f"trainer.num_devices=0 (all visible): {n_visible} CUDA devices are visible, "
              f"and this process trains on one of them ({dev}); launch it with torchrun "
              f"--nproc_per_node={n_visible} to train on all", flush=True)
    return dev


def build_run(cfg: Config, device: DeviceLike = None):
    """(device, model configuration, fresh TrainState, step function) of a
    run, as ``train_jepa`` builds them before it restores a checkpoint: the
    initial weights are the seeded ones, broadcast from rank 0 in a process
    group, and under tensor parallelism this rank's shard of them, so that
    every ``trainer.model_parallel`` starts from the same weights."""
    dev = join_run(cfg, device)
    model_cfg = cfg.build_model_config()  # raises on settings the port lacks
    mp = cfg.trainer.model_parallel
    init_layout(mp)
    model = JEPA(model_cfg)
    model.init_parameters(torch.Generator().manual_seed(cfg.trainer.seed))
    replicated(model.to(dev))
    if mp > 1:
        model = sharded(model, JEPA(model_cfg, mp).to(dev))
    state = TrainState.create(model, make_optimizer(cfg.optimizer, model))
    masker, masker_cfg = cfg.masker.build()
    step_fn = make_jepa_train_step(
        cfg.optimizer,
        nr_samples_per_audio=cfg.data.samples_per_audio,
        masker=masker,
        masker_cfg=masker_cfg,
        ema_cfg=cfg.ema,
        scene_cfg=scene_config(cfg),
        accum_steps=cfg.resolved_accum_steps(),
    )
    return dev, model_cfg, state, step_fn


def train_jepa(
    cfg: Config,
    data_iter: Optional[Iterator[np.ndarray]] = None,
    max_steps: Optional[int] = None,
    device: DeviceLike = None,
) -> TrainState:
    """Run (or resume) JEPA pretraining on ``device`` (cuda unless told
    otherwise; raises without CUDA), as one rank of a data-parallel run when
    launched under torchrun. Returns the final TrainState.

    Without ``data_iter`` the batches come from ``build_data_iterator``,
    and a shard pipeline built here is stopped when the loop returns or
    raises. Each step logs ``data_wait_ms``, the time the loop waited for
    its batch. The host bank of a scene source with banks (a
    ``ShardBatches`` over a ``DenoiseSampleSource``, as
    ``build_data_iterator`` gives) goes to the device once, and the loop
    refreshes it (``run_step``)."""
    dev, model_cfg, state, step_fn = build_run(cfg, device)
    run_dir = Path(cfg.trainer.save_dir) / cfg.run_identity()
    ckpt = open_run(run_dir, model_cfg, state, cfg, cfg.trainer.ckpt_every)
    owned = None
    if data_iter is None:  # built after the restore: the stream starts at the next step
        data_iter = owned = build_data_iterator(cfg, start_step=state.step)
    total = max_steps if max_steps is not None else cfg.trainer.steps
    return run_loop(cfg, state, step_fn, data_iter, owned, run_dir, ckpt, total, dev)


def open_run(run_dir: Path, model_cfg, state, cfg: Config, every: int) -> CheckpointManager:
    """Write the run's ``model_config.json`` (rank 0), and restore ``state``
    in place from the newest checkpoint under ``run_dir/ckpt`` if there is
    one (every rank). Returns the run's CheckpointManager (saving every
    ``every`` steps)."""
    main = process_group()[0] == 0
    if main:
        write_model_config(run_dir, model_cfg)
    ckpt = CheckpointManager(run_dir / "ckpt", keep=cfg.trainer.keep_ckpts, every=every)
    latest = from_rank_zero(ckpt.latest_step())
    if latest is not None:
        ckpt.restore(state, latest)
        if main:
            print(f"resumed from step {state.step}", flush=True)
    return ckpt


def run_loop(cfg: Config, state, step_fn, data_iter: Iterator, owned, run_dir: Path,
             ckpt: CheckpointManager, total: int, dev: torch.device):
    """The step loop of a run, from ``state.step`` to ``total``: batches
    from ``data_iter`` through the prefetch thread (a scene source's bank on
    the device, refreshed by ``run_step``), each step's generator seeded
    from (seed, step), metrics with throughput and ``data_wait_ms`` every
    ``trainer.log_every`` steps into ``run_dir/logs``, checkpoints by
    ``ckpt`` and one at the end. ``step_fn(state, batch, generator,
    rir_bank)``. ``owned`` (the shard pipeline the caller built, or None)
    is stopped when the loop returns or raises. In a process group rank 0
    logs the metrics, which are global, with rates over all ranks and a
    card."""
    rank, world = process_group()
    logger = MetricLogger(str(run_dir / "logs")) if rank == 0 else None
    throughput = Throughput(cfg.trainer.batch_size,
                            cfg.trainer.batch_size * cfg.data.samples_per_audio, world)
    rir_bank = same_over_model_group(device_scene_bank(data_iter, dev))
    generator = torch.Generator(device=dev)
    batches = prefetch_to_device(data_iter, dev)
    wait_s, waited_steps = 0.0, 0
    try:
        while state.step < total:
            t0 = time.perf_counter()
            batch = same_over_model_group(next(batches))  # one replica, one batch
            wait_s += time.perf_counter() - t0
            waited_steps += 1
            generator.manual_seed(step_seed(cfg.trainer.seed, state.step))
            state, metrics = run_step(step_fn, state, batch, generator, rir_bank)
            throughput.step()
            if logger and (state.step % cfg.trainer.log_every == 0 or state.step == total):
                scalars = {k: float(v) for k, v in metrics.items()}  # waits for the device
                scalars.update(throughput.rates())
                scalars["data_wait_ms"] = 1000.0 * wait_s / waited_steps
                wait_s, waited_steps = 0.0, 0
                throughput.start()
                logger.log(state.step, scalars)
            if ckpt.save(state.step, state) and logger:
                print(f"checkpoint @ {state.step}", flush=True)
    finally:
        if hasattr(owned, "stop"):  # the shard pipeline's worker processes
            owned.stop()
        batches.close()
        if logger:
            logger.close()
    if ckpt.saved != state.step:  # the same on every rank, unlike the directory
        ckpt.save(state.step, state, force=True)
    return state
