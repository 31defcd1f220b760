"""Denoiser: robustness distillation of WavJEPA onto noisy, reverberant
scenes.

Counterpart of ``wavjepa_tpu/models/denoiser.py``. The student is the JEPA
encoder path alone (``EncoderPath``: conv frontend → feature LayerNorm →
mapper → positions → context encoder, no predictor), under the reference's
names, so its state_dict is the encoder side of a JEPA checkpoint and the
HEAR runtime serves it. The teacher is a frozen JEPA whose ``represent`` on
the clean view is the target:

    loss = α · MSE(student(clean), teacher(clean))
         + (1 − α) · MSE(student(noisy), teacher(clean))
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE, JEPA, EncoderPath, JEPAConfig
from wavjepa_tpu_torch.parallel.mesh import shard_params


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """The denoiser's hyperparameters and the scene knobs of its step."""

    jepa: JEPAConfig = JEPAConfig()
    alpha: float = 0.0  # weight of the clean-view loss term
    original_sr: int = 32000  # the scene-synthesis rate
    nr_samples_per_audio: int = 16
    target_seconds: float = 10.0
    # at alpha = 0 the clean view only feeds the logged loss_clean; False
    # skips its student forward (loss_clean is then reported as 0)
    log_clean_loss: bool = True

    @property
    def scene_length(self) -> int:
        return int(self.original_sr * self.target_seconds)


class DenoiserStudent(EncoderPath):
    """The JEPA encoder path as a module of its own: (B, C, T_samples) →
    (B, total_patches, D_enc) contextual features."""

    @staticmethod
    def remat_flags(cfg: JEPAConfig) -> tuple[bool, bool, bool]:
        """The JAX ``DenoiserStudent``'s rule, not ``JEPA``'s: ``cfg.remat``
        for the conv frontend and the encoder, ``remat_conv`` and
        ``remat_encoder`` ignored, and the probabilities never kept
        (``wavjepa_tpu/models/denoiser.py``)."""
        return cfg.remat, cfg.remat, False

    def forward(self, audio: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.represent(audio, padding_mask)


def student_from_jepa(teacher: JEPA, model_parallel: int = 1) -> DenoiserStudent:
    """A student warm-started from ``teacher``'s encoder path, on its
    device; at ``model_parallel`` > 1 this rank's shard of it (the teacher
    stays whole: it takes no gradient). ``load_state_dict`` copies, so no
    tensor of the student shares storage with the teacher's, and the
    student's updates leave the teacher as it was."""
    student = DenoiserStudent(teacher.config, model_parallel)
    student.load_state_dict(shard_params({k: v for k, v in teacher.state_dict().items()
                                          if k.startswith(ENCODER_SIDE)}))
    return student.to(teacher.pos_encoding_encoder.device)


def denoiser_distillation_loss(
    student_clean: Optional[torch.Tensor],
    student_noisy: torch.Tensor,
    teacher_clean: torch.Tensor,
    alpha: float,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """α-blended full-sequence MSE in f32 against the detached teacher →
    (loss, {"loss_clean", "loss_denoise_dereverb"}). ``student_clean=None``
    (legal only at alpha 0) leaves out the clean term; loss_clean is then
    reported as 0."""
    teacher = teacher_clean.detach().float()
    loss_dn = (student_noisy.float() - teacher).square().mean()
    if student_clean is None:
        if alpha != 0.0:
            raise ValueError("student_clean may only be omitted at alpha=0.0")
        return loss_dn, {"loss_clean": loss_dn.new_zeros(()), "loss_denoise_dereverb": loss_dn}
    loss_clean = (student_clean.float() - teacher).square().mean()
    loss = alpha * loss_clean + (1.0 - alpha) * loss_dn
    return loss, {"loss_clean": loss_clean, "loss_denoise_dereverb": loss_dn}
