"""Train state: the student, the EMA teacher encoder, the optimizer and the
step counter.

Counterpart of ``wavjepa_tpu/train/state.py``. The JAX package keeps the
teacher as a second parameter tree and builds a new state each step; here
the teacher is a second encoder module outside autograd, and the step
updates all four in place, which keeps one copy of each in memory.
"""

from __future__ import annotations

import dataclasses

import torch

from wavjepa_tpu_torch.models.jepa import JEPA
from wavjepa_tpu_torch.ops.transformer import TransformerEncoder

TEACHER_PREFIX = "teacher_encoder."


@dataclasses.dataclass
class TrainState:
    model: JEPA
    teacher_encoder: TransformerEncoder  # EMA copy of model.encoder
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: JEPA, optimizer: torch.optim.Optimizer) -> "TrainState":
        return cls(model, model.build_teacher_encoder(), optimizer, 0)

    def weights(self) -> dict[str, torch.Tensor]:
        """The student's state_dict plus ``teacher_encoder.*``."""
        sd = dict(self.model.state_dict())
        sd.update({f"{TEACHER_PREFIX}{k}": v
                   for k, v in self.teacher_encoder.state_dict().items()})
        return sd

    def load_weights(self, sd: dict) -> None:
        self.model.load_state_dict({k: v for k, v in sd.items()
                                    if not k.startswith(TEACHER_PREFIX)})
        n = len(TEACHER_PREFIX)
        self.teacher_encoder.load_state_dict({k[n:]: v for k, v in sd.items()
                                              if k.startswith(TEACHER_PREFIX)})


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, decay: float) -> None:
    """teacher ← decay·teacher + (1 − decay)·student, in place, in f32 (the
    parameters are f32), over the two modules' parameters in order."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    torch._foreach_mul_(t, decay)
    torch._foreach_add_(t, s, alpha=1.0 - decay)
