"""Train state: the student, the EMA teacher encoder, the optimizer and the
step counter.

Counterpart of ``wavjepa_tpu/train/state.py``. The JAX package keeps the
teacher as a second parameter tree and builds a new state each step; here
the teacher is a second encoder module outside autograd, and the step
updates all four in place, which keeps one copy of each in memory.

Under tensor parallelism (``parallel/mesh.py``) the student, the teacher
and the AdamW moments are a rank's shards: ``weights()`` and
``full_state()`` gather the whole tensors over the tensor-parallel group
(every rank of it must call them), ``load_full_state()`` takes whole ones
and keeps the rank's shard, and the EMA stays elementwise on the shards.
"""

from __future__ import annotations

import dataclasses

import torch

from wavjepa_tpu_torch.models.jepa import JEPA
from wavjepa_tpu_torch.ops.transformer import TransformerEncoder
from wavjepa_tpu_torch.parallel.mesh import gather_params, gather_train_state, shard_train_state

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

    def _local(self) -> dict[str, torch.Tensor]:
        sd = dict(self.model.state_dict())
        sd.update({f"{TEACHER_PREFIX}{k}": v
                   for k, v in self.teacher_encoder.state_dict().items()})
        return sd

    def weights(self) -> dict[str, torch.Tensor]:
        """The student's state_dict plus ``teacher_encoder.*``, whole."""
        return gather_params(self._local())

    def full_state(self) -> tuple[dict, dict]:
        """(``weights()``, the optimizer's ``state_dict`` with whole AdamW
        moments): what a checkpoint holds."""
        return gather_train_state(self._local(), self.optimizer.state_dict(),
                                  param_names(self.model))

    def load_full_state(self, weights: dict, opt_state: dict) -> None:
        """``full_state()``' pair → this rank's shards, in place."""
        weights, opt_state = shard_train_state(weights, opt_state, param_names(self.model))
        self.model.load_state_dict({k: v for k, v in weights.items()
                                    if not k.startswith(TEACHER_PREFIX)})
        n = len(TEACHER_PREFIX)
        self.teacher_encoder.load_state_dict({k[n:]: v for k, v in weights.items()
                                              if k.startswith(TEACHER_PREFIX)})
        self.optimizer.load_state_dict(opt_state)


def param_names(module: torch.nn.Module) -> list[str]:
    """The names of ``module.parameters()``, in the order an optimizer over
    them numbers its per-parameter state."""
    return [name for name, _ in module.named_parameters()]


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, decay: float) -> None:
    """teacher ← decay·teacher + (1 − decay)·student, in place, in f32 (the
    parameters are f32), over the two modules' parameters in order."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    torch._foreach_mul_(t, decay)
    torch._foreach_add_(t, s, alpha=1.0 - decay)
