"""The X-ARES encoder validation (``xares.audio_encoder_checker.
check_audio_encoder``): random audio of several durations and batch sizes
through the encoder, and the contract the harness relies on. The port's
copy of ``wavjepa_tpu/eval/xares/checker.py``; the encoder's outputs may
lie on any device."""

from __future__ import annotations

import torch


def check_audio_encoder(encoder: torch.nn.Module, verbose: bool = False) -> bool:
    """Validate the X-ARES encoder contract. Returns True when compliant;
    raises AssertionError with the violated clause otherwise."""
    for attr, typ in (
        ("sampling_rate", int),
        ("output_dim", int),
        ("hop_size_in_ms", (int, float)),
    ):
        assert hasattr(encoder, attr), f"encoder lacks required attribute {attr}"
        assert isinstance(getattr(encoder, attr), typ), (
            f"{attr} must be {typ}, got {type(getattr(encoder, attr))}"
        )
    sr = encoder.sampling_rate
    assert sr > 0 and encoder.output_dim > 0 and encoder.hop_size_in_ms > 0

    torch.manual_seed(0)
    for batch, seconds in ((1, 0.5), (2, 3.1), (4, 10.0)):
        audio = torch.randn(batch, int(sr * seconds))
        out = encoder(audio)
        assert isinstance(out, torch.Tensor), "output must be a torch.Tensor"
        assert out.dim() == 3, f"output must be (B, T', D), got {out.shape}"
        assert out.shape[0] == batch, "batch dimension mismatch"
        assert out.shape[2] == encoder.output_dim, (
            f"last dim {out.shape[2]} != output_dim {encoder.output_dim}"
        )
        assert out.shape[1] > 0, "no output frames"
        assert torch.isfinite(out).all(), "non-finite embeddings"
        if verbose:
            print(f"  ({batch}, {seconds:.1f}s) -> {tuple(out.shape)}")

    # longer audio must yield at least as many frames
    short = encoder(torch.randn(1, sr))
    long = encoder(torch.randn(1, 3 * sr))
    assert long.shape[1] >= short.shape[1], "frame count not monotone in length"
    return True
