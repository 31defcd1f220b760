"""WavJEPA in PyTorch for NVIDIA Hopper (H100).

The second package beside ``wavjepa_tpu``: the same models and entry points,
written with ``torch`` and hand-written CUDA kernels for ``sm_90a``. It
imports nothing of JAX and nothing of ``wavjepa_tpu``; the JAX package is
only the reference its tests compare against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper computes its plain PyTorch version instead.
"""

__version__ = "0.1.0"
