"""X-ARES evaluation surface of the PyTorch port.

  * ``encoder``: ``WavJEPAEncoder``, the X-ARES encoder contract over the
    port's runtime (what ``xares.run`` imports);
  * ``checker``: ``check_audio_encoder``, the contract's validation, so it
    is testable without the xares package;
  * ``run``: a task runner that hands over to a real ``xares`` installation
    when there is one, else runs the same frozen-encoder → probe protocol on
    a synthetic stub task;
  * ``vendored_protocol``: the task-module interface (``TaskConfig``, the
    ESC-50 and FSD50K factories, encode → probe → metric, the kNN leg).
"""

from wavjepa_tpu_torch.eval.xares.checker import check_audio_encoder
from wavjepa_tpu_torch.eval.xares.encoder import WavJEPAEncoder

__all__ = ["WavJEPAEncoder", "check_audio_encoder"]
