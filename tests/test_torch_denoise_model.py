"""The denoiser's student and loss in the port against the JAX package's, at
tests/test_denoiser.py's tiny size: the student forward from JAX-initialised
weights carried across with ``state_dict_from_jax_params`` (f32, atol 5e-5,
rtol 1e-4, as tests/test_torch_model.py), the α-blended loss at α = 0, 0.3
and 1 (rtol 1e-6); then the port alone: the warm-started student equals
the teacher's ``represent`` and shares no storage with it, so an optimizer
step on the student leaves every teacher tensor bitwise as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.models.denoiser import DenoiserStudent as JaxStudent
from wavjepa_tpu.models.denoiser import denoiser_distillation_loss as jax_loss
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.models.denoiser import (
    DenoiserConfig,
    DenoiserStudent,
    denoiser_distillation_loss,
    student_from_jepa,
)
from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE, JEPA, JEPAConfig

# tests/test_denoiser.py's TINY
TINY = dict(conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
            encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
            sample_rate=1600, process_seconds=0.201, average_top_k_layers=2)


def _audio(seed, n=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 1, JEPAConfig(**TINY).target_length)).astype(np.float32)


def test_student_forward_matches_the_jax_student():
    jstudent = JaxStudent(JaxConfig(**TINY))
    x = _audio(0)
    params = jax.tree.map(np.asarray, jstudent.init(jax.random.PRNGKey(3), jnp.asarray(x))
                          ["params"])
    mask = np.zeros((3, JEPAConfig(**TINY).total_patches), bool)
    mask[1, 20:] = True
    ref = np.asarray(jstudent.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))

    student = DenoiserStudent(JEPAConfig(**TINY))
    sd = state_dict_from_jax_params(params)
    assert set(sd) == set(student.state_dict())  # the encoder side, reference names
    assert all(k.startswith(ENCODER_SIDE) for k in sd)
    student.load_state_dict(sd)
    with torch.no_grad():
        out = student(torch.from_numpy(x), torch.from_numpy(mask))
    assert out.shape == ref.shape == (3, 31, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_distillation_loss_blend_matches_jax(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    clean, noisy, teacher = (rng.standard_normal((2, 5, 8)).astype(np.float32)
                             for _ in range(3))
    ref, ref_parts = jax_loss(jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(teacher), alpha)
    loss, parts = denoiser_distillation_loss(*(torch.from_numpy(a) for a in (clean, noisy,
                                                                               teacher)), alpha)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    for k in ("loss_clean", "loss_denoise_dereverb"):
        np.testing.assert_allclose(parts[k].item(), float(ref_parts[k]), rtol=1e-6)
    if alpha == 0.0:  # the clean term may be left out, and is reported as 0
        loss, parts = denoiser_distillation_loss(None, torch.from_numpy(noisy),
                                                 torch.from_numpy(teacher), 0.0)
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
        assert parts["loss_clean"].item() == 0.0
    else:
        with pytest.raises(ValueError, match="alpha=0.0"):
            denoiser_distillation_loss(None, torch.from_numpy(noisy),
                                       torch.from_numpy(teacher), alpha)


def test_the_loss_takes_no_gradient_into_the_teacher():
    t = torch.randn(2, 4, 8, requires_grad=True)
    s = torch.randn(2, 4, 8, requires_grad=True)
    loss, _ = denoiser_distillation_loss(s, s * 2, t, 0.5)
    loss.backward()
    assert t.grad is None and s.grad is not None


def test_warm_started_student_is_the_teachers_encoder_path_and_shares_nothing():
    teacher = JEPA(JEPAConfig(**TINY))
    teacher.init_parameters(torch.Generator().manual_seed(0))
    teacher.requires_grad_(False)
    student = student_from_jepa(teacher)
    x = torch.from_numpy(_audio(1))
    with torch.no_grad():
        torch.testing.assert_close(student(x), teacher.represent(x), rtol=0, atol=0)
    t_ptrs = {v.untyped_storage().data_ptr() for v in teacher.state_dict().values()}
    assert not t_ptrs & {p.untyped_storage().data_ptr() for p in student.parameters()}
    assert all(p.requires_grad for p in student.parameters())

    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    opt = torch.optim.AdamW(student.parameters(), lr=1e-2)
    student(x).square().mean().backward()
    opt.step()
    moved = sum((p - before[k]).abs().sum().item() for k, p in student.state_dict().items())
    assert moved > 0
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_denoiser_config_scene_length():
    assert DenoiserConfig().scene_length == 320000
    assert DenoiserConfig(original_sr=3200, target_seconds=1.0).scene_length == 3200
