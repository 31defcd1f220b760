"""heaRIR: eval-time acoustic-scene augmentation for robustness experiments.

The port's copy of ``wavjepa_tpu/api/hearir.py`` (the reference's
hear_api/heaRIR: augment.py, iterators/SceneIterator.py,
iterators/NoiseIterator.py), on the host with numpy and scipy, with decoding
and resampling from the port's ``data/``: builds noisy and reverberant
variants of HEAR eval audio by sampling a spatial scene (a source RIR and up
to ``max_noise_sources`` noise RIRs from scene-spec JSONs), convolving, and
mixing at a signal-to-noise ratio. HEAR augmentation happens file by file
during embedding extraction, so it stays on the host.

Scene-spec JSON contract (same as the reference's):
    {"sampled_regions": [{"region": {"scene": {
        "source": {"rir": {"binaural_rir_path": ..., "ambisonic_rir_path": ...}},
        "noise": [{"rir": {...}}, ...]}}}, ...]}
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def _load_rir(path: str, channels: int, rir_len: int) -> np.ndarray:
    """Load an npy/wav RIR → (channels, rir_len), zero-padded."""
    p = Path(path)
    if p.suffix == ".npy":
        arr = np.load(p).astype(np.float32)
    else:
        from wavjepa_tpu_torch.data.decode import decode_audio

        arr, _ = decode_audio({p.suffix.lstrip("."): p.read_bytes()})
    if arr.ndim == 1:
        arr = arr[None]
    arr = arr[:channels]
    out = np.zeros((channels, rir_len), np.float32)
    t = min(arr.shape[-1], rir_len)
    out[: arr.shape[0], :t] = arr[:, :t]
    return out


class SceneIterator:
    """Thread-safe random sampler of spatial scenes from spec JSONs
    (reference SceneIterator.py:30-132): yields
    (source_rir (C, L), [noise_rirs (C, L)], meta)."""

    def __init__(
        self,
        scene_spec_paths: List[str],
        rir_type: str = "binaural",  # "binaural" (2ch) | "ambisonic" (4ch)
        sr: int = 16000,
        rir_seconds: float = 2.0,
        max_noise_sources: int = 5,
        seed: int = 0,
    ):
        self.channels = {"binaural": 2, "ambisonic": 4}[rir_type]
        self.rir_key = f"{rir_type}_rir_path"
        self.rir_len = int(sr * rir_seconds)
        self.max_noise = max_noise_sources
        self._lock = threading.RLock()
        self._rng = np.random.default_rng(seed)
        self.regions = []
        for path in scene_spec_paths:
            spec = json.loads(Path(path).read_text())
            self.regions.extend(spec.get("sampled_regions", []))
        if not self.regions:
            raise ValueError("no sampled_regions found in scene specs")

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, List[np.ndarray], dict]:
        with self._lock:
            region = self.regions[int(self._rng.integers(len(self.regions)))]
        scene = region["region"]["scene"]
        source_rir = _load_rir(
            scene["source"]["rir"][self.rir_key], self.channels, self.rir_len
        )
        noise_rirs = [
            _load_rir(n["rir"][self.rir_key], self.channels, self.rir_len)
            for n in scene.get("noise", [])[: self.max_noise]
        ]
        return source_rir, noise_rirs, {"region": region}


class NoiseIterator:
    """Infinite random sampler over a directory of noise wav files
    (reference NoiseIterator.py:8-41, WHAM!)."""

    def __init__(self, noise_dir: str, sr: int = 16000, seed: int = 0):
        self.paths = sorted(
            str(p) for p in Path(noise_dir).rglob("*") if p.suffix in (".wav", ".flac")
        )
        if not self.paths:
            raise ValueError(f"no noise audio found under {noise_dir}")
        self.sr = sr
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        from wavjepa_tpu_torch.data.decode import decode_audio
        from wavjepa_tpu_torch.data.resample import resample_np

        path = Path(self.paths[int(self._rng.integers(len(self.paths)))])
        wav, sr = decode_audio({path.suffix.lstrip("."): path.read_bytes()})
        wav = wav[0]
        if sr is not None and sr != self.sr:
            wav = resample_np(wav[None], sr, self.sr)[0]
        return wav.astype(np.float32)


def _fft_convolve_trunc(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    from scipy.signal import fftconvolve

    return fftconvolve(x, k, mode="full", axes=-1)[..., : x.shape[-1]]


def _fade_noise(noise: np.ndarray, target_len: int, sr: int,
                duration: float = 0.2) -> np.ndarray:
    """Reference fade_noise (heaRIR/scene_module/generate_scenes.py:143-154):
    noise longer than the audio is cut (from the start) and fade-OUT is
    applied; otherwise both a fade-in and a fade-out (linear, 0.2 s)."""
    noise = noise.astype(np.float32).copy()
    n = int(duration * sr)
    if noise.shape[-1] > target_len:
        noise = noise[:target_len].copy()
        m = min(n, noise.shape[-1])
        noise[-m:] *= np.linspace(1.0, 0.0, m, dtype=np.float32)
    else:
        m = min(n, noise.shape[-1])
        noise[:m] *= np.linspace(0.0, 1.0, m, dtype=np.float32)
        noise[-m:] *= np.linspace(1.0, 0.0, m, dtype=np.float32)
    return noise


class Augmenter:
    """Applies a random spatial scene to eval audio, reproducing the
    reference pipeline exactly (augment.py:8-62 →
    heaRIR/scene_module/generate_scenes.py:process_audio/add_noise):
    0.2-s linear noise fades, per-RIR convolution of the faded noise at its
    own length, aggregation + truncation, RANDOM placement of a shorter
    noise bed, and full-signal SNR scaling
    (a = 10^((10·log10(E_sig/E_noise) − snr)/20)). Output truncated to the
    input length."""

    def __init__(
        self,
        spatial_scene_iter: Optional[SceneIterator],
        sr: int,
        snr: Optional[float],
        noise_iter: Optional[NoiseIterator] = None,
        seed: int = 0,
    ):
        self.spatial_scene_iter = spatial_scene_iter
        self.sr = sr
        self.snr = snr
        self.noise_iter = noise_iter
        self._rng = np.random.default_rng(seed)

    def augment(
        self, audio: np.ndarray, noise: Optional[np.ndarray] = None
    ) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        squeeze = audio.ndim == 1
        if squeeze:
            audio = audio[None]
        input_len = audio.shape[-1]

        if self.spatial_scene_iter is None:
            return audio[:, :input_len]

        source_rir, noise_rirs, _ = next(self.spatial_scene_iter)
        if source_rir.shape[-1] > input_len:
            audio = np.pad(
                audio, ((0, 0), (0, source_rir.shape[-1] - input_len))
            )
        padded_len = audio.shape[-1]
        wet = _fft_convolve_trunc(audio[:, None, :], source_rir[None])[0]  # (C,T)

        if noise is None and self.noise_iter is not None and self.snr is not None:
            noise = next(self.noise_iter)
        if noise is not None and self.snr is not None and noise_rirs:
            noise = _fade_noise(
                np.asarray(noise, np.float32).ravel(), padded_len, self.sr
            )
            # aggregate: convolve the faded noise with each RIR at the
            # NOISE's length, sum, then truncate to the padded audio length
            agg = np.zeros((wet.shape[0], noise.shape[-1]), np.float32)
            for rir in noise_rirs:
                agg += _fft_convolve_trunc(noise[None, :], rir)[
                    :, : noise.shape[-1]
                ]
            agg = agg[:, :padded_len]
            if wet.shape[-1] > agg.shape[-1]:
                # shorter noise lands at a random offset (process_audio's
                # np.random.randint(0, input_length - agg_len))
                start = int(
                    self._rng.integers(0, padded_len - agg.shape[-1])
                )
                placed = np.zeros_like(wet)
                placed[:, start : start + agg.shape[-1]] = agg
                agg = placed
            e_sig = np.sum(wet**2)
            e_noise = np.sum(agg**2)
            # add_noise: scale = 10^((orig_snr_db − snr)/20)
            a = np.sqrt(e_sig / (e_noise + 1e-9) * 10.0 ** (-self.snr / 10.0))
            wet = wet + a * agg

        return wet[:, :input_len]
