"""The general traffic generator: every input of a run, from its seed and a
traffic file's parameters (``wavbench/traffic/<name>.json``).

``kind`` picks what a batch is:

- ``mixtures``: (B, 1, samples) float32 clips that differ from one another
  as recordings do (``mixture_clips``): coloured noise, a few tones, and a
  loudness envelope, each drawn a clip. The port's synthetic source
  (``wavjepa_tpu_torch/data/synthetic.synthetic_audio_batches``) low-passes
  white noise alike for every clip, so that half of a batch trains as the
  whole does to within bf16's rounding, and a step that drops half of its
  batch could not be told from a sound one;
- ``scenes``: scene parts at the synthesis rate, as the port's synthetic
  scene source draws them (``wavjepa_tpu_torch/train/denoise_loop.
  synthetic_denoise_batches`` as of commit
  cdac4308582b9b00131171bfbc04c0a840de7394), with ``mixture_clips`` as the
  clean sources: a unit impulse plus a short random tail a channel for the
  source's RIR; white noise over the whole clip at a uniform SNR;
  ``max_noise`` noise sources with unit-impulse RIRs;
- ``requests``: closed-loop embedding requests of ``clips_per_request``
  mono clips, all of one duration, the durations taken in blocks that hold
  each listed duration once, in an order drawn from the seed, so that every
  seed sends the same mix of sizes.

A run draws a pool of distinct batches (``pool``) once, in set-up, and
cycles through it: the work is fixed by the seed and the host's drawing
stays out of the measured window.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng((int(seed) % (2**64), *key))


def mixture_clips(rng: np.random.Generator, clips: int, length: int, sr: int,
                  t: dict) -> np.ndarray:
    """(clips, length) float32: white noise through a one-pole filter of a
    coefficient drawn in ``colour``, plus ``tones`` sinusoids (a count drawn
    in that range, log-uniform frequencies in ``tone_hz``, random phases,
    amplitudes up to twice the noise's RMS), under a loudness envelope that
    takes a level in ``envelope_db`` every ``envelope_block_s``."""
    from scipy.signal import lfilter

    noise = rng.standard_normal((clips, length), dtype=np.float32)
    poles = rng.uniform(*t["colour"], clips)
    out = np.stack([lfilter([1.0], [1.0, -a], row) * np.sqrt(1.0 - a * a)
                    for a, row in zip(poles, noise)])
    times = np.arange(length) / sr
    lo, hi = np.log(t["tone_hz"][0]), np.log(t["tone_hz"][1])
    for k in range(clips):
        for _ in range(rng.integers(t["tones"][0], t["tones"][1] + 1)):
            hz = np.exp(rng.uniform(lo, hi))
            out[k] += rng.uniform(0.0, 2.0 * np.sqrt(2.0)) * np.sin(
                2 * np.pi * hz * times + rng.uniform(0, 2 * np.pi))
    block = int(t["envelope_block_s"] * sr)
    levels = rng.uniform(*t["envelope_db"], (clips, -(-length // block)))
    gain = np.repeat(10.0 ** (levels / 20.0), block, axis=1)[:, :length]
    return (out * gain).astype(np.float32)


def mixture_batch(t: dict, seed: int, i: int) -> np.ndarray:
    length = int(t["clip_seconds"] * t["sample_rate"])
    return mixture_clips(_rng(seed, i), t["batch_clips"], length, t["sample_rate"], t)[:, None]


def scene_batch(t: dict, seed: int, i: int) -> dict:
    rng = _rng(seed, i)
    b, c = t["batch_clips"], t["channels"]
    length = int(t["clip_seconds"] * t["scene_rate"])
    rir_len = int(t["rir_seconds"] * t["scene_rate"])
    tail = t["rir_tail"]
    batch = {"audio": mixture_clips(rng, b, length, t["scene_rate"], t)}
    rir = np.zeros((b, c, rir_len), np.float32)
    rir[:, :, 0] = 1.0
    rir[:, :, 1:1 + tail] = t["rir_tail_scale"] * rng.standard_normal((b, c, tail),
                                                                       dtype=np.float32)
    batch["source_rir"] = rir
    batch["noise"] = rng.standard_normal((b, length), dtype=np.float32)
    batch["noise_start"] = np.zeros((b,), np.int32)
    batch["noise_length"] = np.full((b,), length, np.int32)
    lo, hi = t["snr_db"]
    batch["snr"] = rng.uniform(lo, hi, (b,)).astype(np.float32)
    noise_rirs = np.zeros((b, t["max_noise"], c, rir_len), np.float32)
    noise_rirs[..., 0] = 1.0
    batch["noise_rirs"] = noise_rirs
    return batch


def train_pool(t: dict, seed: int) -> list:
    make = {"mixtures": mixture_batch, "scenes": scene_batch}[t["kind"]]
    return [make(t, seed, i) for i in range(t["pool"])]


def request_pool(t: dict, seed: int) -> dict:
    """{duration: [pool arrays (clips, samples) float32]}."""
    out = {}
    for j, dur in enumerate(t["durations_s"]):
        length = int(round(dur * t["sample_rate"]))
        out[dur] = []
        for i in range(t["pool"]):
            out[dur].append(mixture_clips(_rng(seed, 1 + j, i), t["clips_per_request"],
                                          length, t["sample_rate"], t))
    return out


def request_durations(t: dict, seed: int):
    """The requests' durations, endlessly: blocks of every listed duration
    once, each block in an order drawn from the seed."""
    rng = _rng(seed, 0)
    while True:
        yield from (t["durations_s"][k] for k in rng.permutation(len(t["durations_s"])))
