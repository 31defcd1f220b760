"""The denoise train step in the port against the JAX package's, at
tests/test_denoiser.py's tiny size (scenes at 3.2 kHz, 1-s clips, a 1.6-kHz
model with 0.201-s crops), on one scene batch from seeded numpy with
2-channel RIRs, of which the mono step takes the first: the scenes and the
3.2k → 1.6k views against the JAX package's, and the crops at the JAX
step's own offsets, shared by both views; then ``step_on`` from the JAX
step's crops against its loss terms (rtol 1e-5), gradient norm (rtol 1e-4)
and updated student weights (atol 2e-6, rtol 1e-4, as
tests/test_torch_train_step.py), at α = 0.3 and α = 0. Then the port alone,
mirroring tests/test_denoiser.py: accumulation against one pass, the dead
view's detach, ``log_clean_loss`` off, noise-only and RIR-only batches, the
inline batch against the banked, int16-wired one, and a bank refresh
applied after the step that consumed its batch."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.data.pipeline import quantize_clip_int16
from wavjepa_tpu.data.resample import resample_jax
from wavjepa_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from wavjepa_tpu.models.denoiser import DenoiserStudent as JaxStudent
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops.audio import instance_normalize as jax_instance_normalize
from wavjepa_tpu.ops.audio import random_crops as jax_random_crops
from wavjepa_tpu.ops.scenes import generate_scene as jax_generate_scene
from wavjepa_tpu.train.denoise_step import DenoiseOptimizerConfig as JaxOptConfig
from wavjepa_tpu.train.denoise_step import DenoiseTrainState as JaxState
from wavjepa_tpu.train.denoise_step import make_denoise_optimizer as jax_make_optimizer
from wavjepa_tpu.train.denoise_step import make_denoise_train_step as jax_make_step
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.models.denoiser import DenoiserConfig, DenoiserStudent
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops.audio import crops_at, instance_normalize
from wavjepa_tpu_torch.ops.resample import resample_torch
from wavjepa_tpu_torch.ops.scenes import update_rir_bank
from wavjepa_tpu_torch.train.denoise_step import (
    DenoiseOptimizerConfig,
    DenoiseTrainState,
    make_denoise_optimizer,
    make_denoise_train_step,
)
from wavjepa_tpu_torch.train.loop import run_step
from wavjepa_tpu_torch.train.step import build_scenes

TINY = dict(conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
            encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
            sample_rate=1600, process_seconds=0.201, average_top_k_layers=2)
DENOISE = dict(original_sr=3200, nr_samples_per_audio=2, target_seconds=1.0)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
B, T32, RIR, N_CROPS = 2, 3200, 320, 2


def _scene_batch(seed=0, channels=2):
    rng = np.random.default_rng(seed)
    rirs = np.zeros((B, channels, RIR), np.float32)
    rirs[:, :, 0] = 1.0
    rirs[:, :, 1:60] = 0.1 * rng.standard_normal((B, channels, 59))
    nrirs = np.zeros((B, 3, channels, RIR), np.float32)
    nrirs[:, 0, :, 0] = 1.0
    nrirs[:, 1, :, 3:40] = 0.2 * rng.standard_normal((B, channels, 37))
    return {
        "audio": rng.standard_normal((B, T32)).astype(np.float32),
        "source_rir": rirs,
        "noise": rng.standard_normal((B, T32)).astype(np.float32),
        "noise_rirs": nrirs,
        "noise_start": np.array([0, 400], np.int32),
        "noise_length": np.array([T32, 2000], np.int32),
        "snr": np.array([2.0, -3.0], np.float32),
    }


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX teacher params, and a student initialised apart (so that
    loss_clean is not 0), as numpy trees."""
    jc = JaxConfig(**TINY)
    x0 = jnp.zeros((1, 1, jc.target_length))
    tparams = jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0), x0)["params"]
    sparams = jax.jit(JaxStudent(jc).init)(jax.random.PRNGKey(9), x0)["params"]
    return jc, jax.tree.map(np.asarray, tparams), jax.tree.map(np.asarray, sparams)


def _port(tparams, sparams, alpha=0.3, accum=1, **dkw):
    cfg = JEPAConfig(**TINY)
    teacher = JEPA(cfg)
    teacher.load_state_dict(state_dict_from_jax_params(tparams))
    teacher.requires_grad_(False)
    student = DenoiserStudent(cfg)
    student.load_state_dict(state_dict_from_jax_params(sparams))
    opt_cfg = DenoiseOptimizerConfig(**OPT)
    state = DenoiseTrainState(student, make_denoise_optimizer(opt_cfg, student))
    dcfg = DenoiserConfig(jepa=cfg, alpha=alpha, **DENOISE, **dkw)
    step = make_denoise_train_step(opt_cfg, dcfg, with_rir=True, with_noise=True,
                                   accum_steps=accum)
    return teacher, state, step


@pytest.mark.parametrize("alpha", [0.3, 0.0])
def test_denoise_step_matches_jax_on_one_scene_batch(jax_side, alpha):
    jc, tparams, sparams = jax_side
    batch = _scene_batch()
    tx, sched = jax_make_optimizer(JaxOptConfig(**OPT))
    dcfg = JaxDenoiserConfig(jepa=jc, alpha=alpha, **DENOISE)
    jstep = jax_make_step(JaxStudent(jc), JaxJEPA(jc), dcfg, tx, sched, with_rir=True,
                          with_noise=True, donate=False)
    rng = jax.random.PRNGKey(7)
    jstate, ref = jstep(JaxState.create(sparams, tx), tparams,
                        {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    # the JAX step's scenes, views and crops, computed as it does
    noisy_ref = jax_generate_scene(
        batch["audio"], batch["source_rir"], batch["noise"], batch["noise_rirs"],
        batch["noise_start"], batch["noise_length"], batch["snr"], with_rir=True,
        with_noise=True)
    noisy_ref = resample_jax(noisy_ref, 3200, 1600)
    clean_ref = resample_jax(jnp.asarray(batch["audio"])[:, None, :], 3200, 1600)
    key = jax.random.fold_in(rng, 0)
    crop_len = jc.target_length
    starts = np.array(jax.random.randint(key, (B, N_CROPS), 0, 1600 - crop_len + 1))
    views_ref = [jax_instance_normalize(jax_random_crops(key, v, crop_len, N_CROPS),
                                        axis=(-2, -1)).reshape(B * N_CROPS, 1, crop_len)
                 for v in (clean_ref, noisy_ref)]

    teacher, state, step = _port(tparams, sparams, alpha)
    noisy = build_scenes(step.scene_cfg, 1600, _tensors(batch))
    assert noisy.shape == noisy_ref.shape == (B, 1, 1600)
    np.testing.assert_allclose(noisy.numpy(), np.asarray(noisy_ref), atol=1e-5, rtol=1e-4)
    # the port's own views at the JAX offsets
    clean = resample_torch(torch.from_numpy(batch["audio"])[:, None, :], 3200, 1600)
    views = [instance_normalize(crops_at(v, torch.from_numpy(starts), crop_len)).reshape(
        B * N_CROPS, 1, crop_len) for v in (clean, noisy)]
    for got, want in zip(views, views_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

    state, m = step.step_on(state, teacher, *(torch.from_numpy(np.array(v))
                                              for v in views_ref))
    assert m["lr"] == pytest.approx(float(ref["lr"]))
    for k in ("loss", "loss_clean", "loss_denoise_dereverb"):
        np.testing.assert_allclose(m[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(m["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-4)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params))
    got = state.student.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4, err_msg=k)
    assert state.step == 1


def test_both_views_are_cut_at_the_same_offsets(jax_side):
    """With neither RIR nor noise the noisy scene is the clean clip, so one
    draw of offsets for both views gives equal crops (a draw a view would
    not)."""
    _, tparams, sparams = jax_side
    step = make_denoise_train_step(DenoiseOptimizerConfig(**OPT), DenoiserConfig(
        jepa=JEPAConfig(**TINY), **DENOISE), with_rir=False, with_noise=False)
    clean, noisy = step.prepare(_tensors({"audio": _scene_batch()["audio"]}),
                                torch.Generator().manual_seed(3))
    assert clean.shape == (B * N_CROPS, 1, JEPAConfig(**TINY).target_length)
    torch.testing.assert_close(noisy, clean, rtol=0, atol=0)
    assert not torch.equal(clean[0], clean[1])  # the crops themselves differ


def _crops(seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 1, JEPAConfig(**TINY).target_length)).astype(np.float32)
    return [instance_normalize(torch.from_numpy(x[i])) for i in range(2)]


def test_accumulation_matches_one_pass(jax_side):
    _, tparams, sparams = jax_side
    out = []
    for accum in (1, 2):
        teacher, state, step = _port(tparams, sparams, 0.3, accum)
        for _ in range(2):
            state, m = step.step_on(state, teacher, *_crops(4))
        out.append((m, state.student.state_dict()))
    (m1, s1), (m2, s2) = out
    for k in ("loss", "loss_clean", "loss_denoise_dereverb"):
        np.testing.assert_allclose(m2[k].item(), m1[k].item(), rtol=1e-5, err_msg=k)
    for k in s1:
        np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(), rtol=2e-4, atol=2e-5)
    teacher, state, step = _port(tparams, sparams, 0.3, 3)
    with pytest.raises(ValueError, match="not divisible"):
        step.step_on(state, teacher, *_crops(4))


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_the_dead_view_detach_is_exact(jax_side, alpha):
    """The dead view's forward without a gradient gives the gradients of the
    loss with both views differentiated."""
    _, tparams, sparams = jax_side
    teacher, state, step = _port(tparams, sparams, alpha)
    clean, noisy = _crops(7, 2)
    student = state.student
    loss, _ = step.loss_fn(student, teacher, clean, noisy)
    g_det = torch.autograd.grad(loss, list(student.parameters()))
    with torch.no_grad():
        targets = teacher.represent(clean)
    from wavjepa_tpu_torch.models.denoiser import denoiser_distillation_loss

    plain, _ = denoiser_distillation_loss(student(clean), student(noisy), targets, alpha)
    g_plain = torch.autograd.grad(plain, list(student.parameters()))
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=1e-6)
    for a, b in zip(g_plain, g_det):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-8)


def test_without_the_clean_loss_the_step_trains_the_same(jax_side):
    _, tparams, sparams = jax_side
    out = []
    for log_clean in (True, False):
        teacher, state, step = _port(tparams, sparams, 0.0, log_clean_loss=log_clean)
        state, m = step.step_on(state, teacher, *_crops(11))
        out.append((m, state.student.state_dict()))
    (m_on, s_on), (m_off, s_off) = out
    assert m_on["loss_clean"].item() > 0.0 and m_off["loss_clean"].item() == 0.0
    np.testing.assert_allclose(m_off["loss"].item(), m_on["loss"].item(), rtol=1e-6)
    for k in s_on:
        np.testing.assert_allclose(s_off[k].numpy(), s_on[k].numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_rir,with_noise", [(False, True), (True, False)])
def test_noise_only_and_rir_only_batches(jax_side, with_rir, with_noise):
    _, tparams, sparams = jax_side
    cfg = JEPAConfig(**TINY)
    teacher, state, _ = _port(tparams, sparams)
    step = make_denoise_train_step(DenoiseOptimizerConfig(**OPT),
                                   DenoiserConfig(jepa=cfg, alpha=0.3, **DENOISE),
                                   with_rir=with_rir, with_noise=with_noise)
    keep = {"audio"} | ({"source_rir"} if with_rir else set()) | (
        {"noise", "noise_start", "noise_length", "snr"} if with_noise else set())
    batch = {k: v for k, v in _scene_batch(2, channels=1).items() if k in keep}
    state, m = step(state, teacher, _tensors(batch), torch.Generator().manual_seed(2))
    assert np.isfinite(m["loss"].item()) and state.step == 1


def test_inline_and_banked_int16_batches_give_the_same_step(jax_side):
    _, tparams, sparams = jax_side
    batch = _scene_batch(1)
    rng = np.random.default_rng(3)
    bank = {"source_rir": rng.standard_normal((4, 2, RIR)).astype(np.float32),
            "noise_rirs": rng.standard_normal((4, 3, 2, RIR)).astype(np.float32),
            "noise": np.zeros((3, T32), np.int16)}
    idx, nidx = np.array([2, 0], np.int32), np.array([1, 2], np.int32)
    bank["source_rir"][idx] = batch["source_rir"]
    bank["noise_rirs"][idx] = batch["noise_rirs"]
    for j, i in zip(nidx, range(B)):  # bank rows left-aligned, placed by noise_start
        s, n = batch["noise_start"][i], batch["noise_length"][i]
        row = np.zeros(T32, np.float32)
        row[:n] = batch["noise"][i, s:s + n]
        bank["noise"][j] = quantize_clip_int16(row)
        placed = np.zeros(T32, np.float32)
        placed[s:s + n] = batch["noise"][i, s:s + n]
        batch["noise"][i] = placed
    banked = {k: v for k, v in batch.items() if k not in ("source_rir", "noise_rirs", "noise")}
    banked.update(rir_index=idx, noise_index=nidx,
                  audio=np.stack([quantize_clip_int16(c) for c in batch["audio"]]))
    losses = []
    for b, rir_bank in ((batch, None), (banked, {k: torch.from_numpy(v)
                                                 for k, v in bank.items()})):
        teacher, state, step = _port(tparams, sparams)
        _, m = step(state, teacher, _tensors(b), torch.Generator().manual_seed(5), rir_bank)
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-3)


def test_a_refresh_is_applied_after_the_step_that_consumed_its_batch(jax_side):
    """Through ``run_step``, as ``train_denoiser``'s loop runs it: the step
    reads the bank rows its batch was drawn for, and the refresh is in the
    bank afterwards. Written before the step, as the JAX package's denoise
    loop does, the crops come out different."""
    _, tparams, sparams = jax_side
    teacher, state, step = _port(tparams, sparams)
    rng = np.random.default_rng(8)
    bank = {"source_rir": torch.from_numpy(rng.standard_normal((3, 1, RIR)).astype(np.float32)),
            "noise_rirs": torch.from_numpy(rng.standard_normal((3, 3, 1, RIR)).astype(np.float32)),
            "noise": torch.from_numpy(np.stack([quantize_clip_int16(r) for r in
                                                rng.standard_normal((3, T32))]))}
    before = {k: v.clone() for k, v in bank.items()}
    refresh = {"slots": {"source_rir": torch.tensor([1]), "noise_rirs": torch.tensor([1]),
                         "noise": torch.tensor([2])},
               "rows": {"source_rir": torch.randn(1, 1, RIR),
                        "noise_rirs": torch.randn(1, 3, 1, RIR),
                        "noise": torch.from_numpy(quantize_clip_int16(
                            rng.standard_normal((1, T32)).astype(np.float32)))}}
    batch = _tensors({"audio": rng.standard_normal((B, T32)).astype(np.float32),
                      "rir_index": np.array([1, 0], np.int32),
                      "noise_index": np.array([2, 0], np.int32),
                      "noise_start": np.array([10, 0], np.int32),
                      "noise_length": np.array([1500, T32], np.int32),
                      "snr": np.array([0.0, 1.0], np.float32)})
    expected = step.prepare(batch, torch.Generator().manual_seed(1), before)
    seen = {}

    def step_fn(s, b, generator, rir_bank):
        seen["crops"] = step.prepare(b, generator, rir_bank)
        return step(s, teacher, b, torch.Generator().manual_seed(1), rir_bank)

    state, m = run_step(step_fn, state, {**batch, "rir_bank_refresh": copy.deepcopy(refresh)},
                        torch.Generator().manual_seed(1), bank)
    assert state.step == 1 and np.isfinite(m["loss"].item())
    for got, want in zip(seen["crops"], expected):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for key, rows in refresh["rows"].items():
        assert torch.equal(bank[key][refresh["slots"][key]], rows)
    jax_order = update_rir_bank({k: v.clone() for k, v in before.items()},
                                refresh["slots"], refresh["rows"])
    _, noisy = step.prepare(batch, torch.Generator().manual_seed(1), jax_order)
    assert not torch.allclose(noisy, expected[1])


def test_denoiser_config_field_defaults_are_the_jax_packages():
    port = dataclasses.asdict(DenoiserConfig())
    jax_cfg = dataclasses.asdict(JaxDenoiserConfig())
    port.pop("jepa")
    jax_cfg.pop("jepa")
    assert port == jax_cfg
    assert dataclasses.asdict(DenoiseOptimizerConfig()) == dataclasses.asdict(JaxOptConfig())
