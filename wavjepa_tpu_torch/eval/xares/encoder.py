"""X-ARES encoder contract over the port's WavJEPA runtime.

The X-ARES harness (``python -m xares.run <encoder.py> <task.py>``) imports
an encoder module and finds in it one ``torch.nn.Module`` subclass with:

    sampling_rate : int     input rate the harness resamples audio to
    output_dim    : int     embedding dimension
    hop_size_in_ms: float   frame hop of the output sequence
    forward(audio: torch.Tensor (B, T) float32) -> torch.Tensor
        (B, n_frames, output_dim) frame-level embeddings

The port's copy of ``wavjepa_tpu/eval/xares/encoder.py``: the runtime
(``api/runtime.RuntimeJEPA``, 2.01-s windows folded into one batched
encoder call) computes on its device, ``cuda`` unless the caller asks for
the CPU, and the frames come back as float32 on the CPU, as the JAX
package returns them. WavJEPA's frames are 10 ms at 16 kHz.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from wavjepa_tpu_torch.api.runtime import DeviceLike, RuntimeJEPA, load_model


class WavJEPAEncoder(torch.nn.Module):
    """X-ARES encoder over the WavJEPA runtime.

    Built from a checkpoint path (a port or reference ``.ckpt``; the
    ``WAVJEPA_CKPT`` environment variable is the path when ``xares.run``
    builds the class with no argument, and seeded weights when it is
    unset), or around an existing runtime.
    """

    def __init__(
        self,
        ckpt_path: Optional[str] = None,
        runtime: Optional[RuntimeJEPA] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if runtime is None:
            ckpt_path = ckpt_path if ckpt_path is not None else os.environ.get(
                "WAVJEPA_CKPT", ""
            )
            runtime = load_model(ckpt_path, device=device)
        self.runtime = runtime
        self.sampling_rate = int(runtime.sample_rate)
        self.output_dim = int(runtime.timestamp_embedding_size)
        # conv stride 160 samples at 16 kHz → 10 ms hop
        samples_per_frame = runtime.unit_frames / runtime.output_steps
        self.hop_size_in_ms = 1000.0 * samples_per_frame / self.sampling_rate

    @torch.inference_mode()
    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) or (T,) float waveform at ``sampling_rate`` →
        (B, n_frames, output_dim) float32 frame embeddings on the CPU."""
        if audio.dim() == 1:
            audio = audio[None]
        if audio.dim() != 2:
            raise ValueError(f"expected (B, T) audio, got shape {tuple(audio.shape)}")
        emb, _ts = self.runtime.get_timestamp_embeddings(audio.detach().float())
        return emb.float().cpu()
