"""Scene batches for training on synthesized scenes (WavJEPA-Nat).

Counterpart of the data half of ``wavjepa_tpu/train/denoise_loop.py``:
``synthetic_denoise_batches``, ``effective_scene_flags`` and
``build_denoise_data_iterator``. The scene length and the RIR length come
from the Nat scene rate (``NatSceneConfig.original_sr``, 32 kHz) and the
run's ``data.target_seconds`` (10 s), and 2-s RIRs. The denoiser's own
training loop is not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from wavjepa_tpu_torch.data.pipeline import ShardBatches, process_group
from wavjepa_tpu_torch.train.config import Config
from wavjepa_tpu_torch.train.step import NatSceneConfig

RIR_SECONDS = 2.0


def synthetic_denoise_batches(
    batch_size: int,
    scene_len: int,
    rir_len: int,
    max_noise: int = 5,
    with_rir: bool = True,
    with_noise: bool = True,
    n_channels: int = 1,
    seed: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Random scene batches, as the JAX package draws them: white clips, a
    unit impulse plus a short random tail a channel for the source's RIR,
    white noise over the whole clip at an SNR in [−5, 5] dB, and
    ``max_noise`` noise sources whose RIRs are unit impulses."""
    rng = np.random.default_rng(seed)
    c = n_channels
    while True:
        batch = {"audio": rng.standard_normal((batch_size, scene_len)).astype(np.float32)}
        if with_rir:
            rir = np.zeros((batch_size, c, rir_len), np.float32)
            rir[:, :, 0] = 1.0
            rir[:, :, 1:200] = 0.05 * rng.standard_normal((batch_size, c, 199))
            batch["source_rir"] = rir
        if with_noise:
            batch["noise"] = rng.standard_normal((batch_size, scene_len)).astype(np.float32)
            batch["noise_start"] = np.zeros((batch_size,), np.int32)
            batch["noise_length"] = np.full((batch_size,), scene_len, np.int32)
            batch["snr"] = rng.uniform(-5, 5, (batch_size,)).astype(np.float32)
            if with_rir:
                nr = np.zeros((batch_size, max_noise, c, rir_len), np.float32)
                nr[:, :, :, 0] = 1.0
                batch["noise_rirs"] = nr
        yield batch


def effective_scene_flags(cfg: Config) -> tuple[bool, bool]:
    """(with_rir, with_noise) that the batches carry: a shard-fed run has
    RIRs and noise only where ``data.rir_dir`` and ``data.noise_dir`` are
    set; synthetic batches have whatever the flags ask."""
    synthetic = cfg.data.synthetic or not cfg.data.data_dirs
    with_rir = cfg.data.with_rir and (synthetic or bool(cfg.data.rir_dir))
    with_noise = cfg.data.with_noise and (synthetic or bool(cfg.data.noise_dir))
    return with_rir, with_noise


def build_denoise_data_iterator(cfg: Config) -> Iterator[dict[str, np.ndarray]]:
    """Scene batches: synthetic ones when ``data.synthetic`` is set or
    ``data.data_dirs`` is empty; else the shard pipeline, started, as a
    ``ShardBatches`` whose ``stop()`` stops its workers and whose
    ``.source.scene_bank()`` is the host bank (None unless
    ``data.rir_bank_size`` or ``data.noise_bank_size`` is above 0), which
    the train loop sends to the device once. The JAX package returns the
    bank beside the batches instead."""
    sr = NatSceneConfig().original_sr
    with_rir, with_noise = effective_scene_flags(cfg)
    if cfg.data.synthetic or not cfg.data.data_dirs:
        return synthetic_denoise_batches(
            cfg.trainer.batch_size,
            scene_len=int(sr * cfg.data.target_seconds),
            rir_len=int(sr * RIR_SECONDS),
            with_rir=with_rir,
            with_noise=with_noise,
            n_channels=cfg.data.in_channels if cfg.data.nat_scenes else 1,
            seed=cfg.trainer.seed,
        )
    from wavjepa_tpu_torch.data.denoise_pipeline import DenoiseSampleSource, denoise_batches

    host_id, num_hosts = process_group()
    source = DenoiseSampleSource(
        cfg.data.data_dirs,
        rir_pattern=cfg.data.rir_dir if with_rir else None,
        noise_pattern=cfg.data.noise_dir if with_noise else None,
        sr=sr,
        target_seconds=cfg.data.target_seconds,
        snr_low=cfg.data.snr_low,
        snr_high=cfg.data.snr_high,
        rir_seconds=RIR_SECONDS,
        num_workers=cfg.data.num_workers,
        host_id=host_id,
        num_hosts=num_hosts,
        seed=cfg.trainer.seed,
        transfer_dtype=cfg.data.transfer_dtype,
        rir_bank_size=cfg.data.rir_bank_size if with_rir else 0,
        noise_bank_size=cfg.data.noise_bank_size if with_noise else 0,
    )
    batches = denoise_batches(source, cfg.trainer.batch_size,
                              refresh_rirs_per_batch=cfg.data.rir_refresh_per_batch)
    return ShardBatches(source, batches)
