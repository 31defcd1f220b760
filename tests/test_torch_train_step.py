"""The port's train step against the JAX package's: the same crops and masks
(numpy, the masks from the JAX masker) and the same carried-across weights
through two steps of ``JEPATrainStep.step_on`` and of JAX's
``jax.value_and_grad(jepa_loss_fn)`` + ``tx.update`` (clip, AdamW) +
``ema_update``; then the step's own properties on the port alone.

f32 throughout. Loss rtol 1e-5 and gradient norm rtol 1e-4 (f32 sums in
another order through two layers of each stack); weights and teacher atol
2e-6, rtol 1e-4 (AdamW moves a weight by lr·g/(|g|+eps) ≤ lr, so the f32
gradient difference reaches the weights scaled down by lr/(|g|+eps))."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavjepa_tpu.masking import TimeInverseMaskConfig as JaxMaskConfig
from wavjepa_tpu.masking import time_inverse_block_masks as jax_masks
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops.audio import instance_normalize as jax_instance_normalize
from wavjepa_tpu.train.schedule import ema_decay_schedule as jax_ema_schedule
from wavjepa_tpu.train.schedule import warmup_cosine_schedule as jax_lr_schedule
from wavjepa_tpu.train.state import TrainState as JaxTrainState
from wavjepa_tpu.train.state import ema_update as jax_ema_update
from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from wavjepa_tpu.train.step import jepa_loss_fn as jax_jepa_loss_fn
from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.train.schedule import ema_decay_schedule, warmup_cosine_schedule
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    EMAConfig,
    OptimizerConfig,
    canonicalize_for_packing,
    make_jepa_train_step,
    make_optimizer,
)

# tests/test_train_step.py's TINY and TINY_MASK
TINY = dict(
    conv_spec=((32, 10, 5), (32, 3, 2)), in_channels=1, encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=2, decoder_dim=16, decoder_heads=4, sample_rate=1600,
    process_seconds=0.201, average_top_k_layers=2,
)
MASK = dict(target_masks_per_context=2, context_mask_prob=0.5, context_mask_length=4,
            target_prob=0.2, target_length=4, ratio_cutoff=0.1)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
EMA_END = 50


def _inputs(seed, n_rows, jc):
    rng = np.random.default_rng(seed)
    crops = rng.standard_normal((n_rows, 1, jc.target_length)).astype(np.float32) * 2 + 0.5
    crops = np.array(jax_instance_normalize(jnp.asarray(crops)))
    masks = jax_masks(jax.random.PRNGKey(seed), batch_size=n_rows, n_times=jc.total_patches,
                      cfg=JaxMaskConfig(**MASK))
    return (crops, *(np.array(m) for m in masks))  # writable copies for torch


def _jax_steps(params, batches, jc):
    model = JaxJEPA(jc)
    tx, sched = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    state = JaxTrainState.create(params, tx)
    ema = jax_ema_schedule(anneal_end_step=EMA_END)
    p, teacher, opt_state, out = state.params, state.teacher_encoder, state.opt_state, []
    for step, (crops, ctx, tgt, vis) in enumerate(batches):
        loss, grads = jax.value_and_grad(jax_jepa_loss_fn, argnums=1)(
            model, p, teacher, *map(jnp.asarray, (crops, ctx, tgt, vis)))
        updates, opt_state = tx.update(grads, opt_state, p)
        teacher = jax_ema_update(teacher, p["encoder"], ema(step))
        p = optax.apply_updates(p, updates)
        out.append((float(loss), float(optax.global_norm(grads)), float(sched(step))))
    return p, teacher, out


def _port_state(params, **kw):
    model = JEPA(JEPAConfig(**TINY, **kw))
    model.load_state_dict(state_dict_from_jax_params(params))
    return TrainState.create(model, make_optimizer(OptimizerConfig(**OPT), model))


def _port_step(accum=1):
    return make_jepa_train_step(OptimizerConfig(**OPT), nr_samples_per_audio=2,
                                masker_cfg=TimeInverseMaskConfig(**MASK),
                                ema_cfg=EMAConfig(anneal_end_step=EMA_END), accum_steps=accum)


@pytest.fixture(scope="module")
def jax_params():
    jc = JaxConfig(**TINY)
    params = JaxJEPA(jc).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))
    return jc, jax.tree.map(np.asarray, params["params"])


def test_two_steps_match_jax(jax_params):
    jc, params = jax_params
    batches = [_inputs(10 + i, 4, jc) for i in range(2)]
    ref_params, ref_teacher, ref = _jax_steps(params, batches, jc)
    state, step = _port_state(params), _port_step()
    for i, batch in enumerate(batches):
        state, m = step.step_on(state, *map(torch.from_numpy, batch))
        loss, g_norm, lr = ref[i]
        np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), g_norm, rtol=1e-4)
        np.testing.assert_allclose(m["lr"], lr, rtol=1e-6)
    assert state.step == 2 and ref[1][2] > 0  # the second update has a learning rate
    ref_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, ref_params),
                                        teacher_encoder=jax.tree.map(np.asarray, ref_teacher))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=2e-6, rtol=1e-4, err_msg=k)
    for k, v in state.teacher_encoder.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[f"teacher_encoder.{k}"].numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=k)


def test_clip_is_optax_clip_by_global_norm(jax_params):
    # the optimizer's update is skipped, so the gradients left in place are
    # the clipped ones; a grad_clip of 1e-3 makes the clip bite
    jc, params = jax_params
    opt = dict(OPT, grad_clip=1e-3)
    batch = _inputs(20, 4, jc)
    tx = optax.clip_by_global_norm(1e-3)
    loss, grads = jax.value_and_grad(jax_jepa_loss_fn, argnums=1)(
        JaxJEPA(jc), params, params["encoder"], *map(jnp.asarray, batch))
    clipped, _ = tx.update(grads, tx.init(params))
    state = _port_state(params)
    step = make_jepa_train_step(OptimizerConfig(**opt), nr_samples_per_audio=2,
                                masker_cfg=TimeInverseMaskConfig(**MASK))
    state.optimizer.step = lambda: None  # keep the clipped gradients in place
    state, m = step.step_on(state, *map(torch.from_numpy, batch))
    assert m["grad_norm"].item() > 1e-3
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, clipped))
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), atol=1e-9, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("packed", [False, True])
def test_accumulation_equals_one_pass(jax_params, packed):
    jc, params = jax_params
    kw = dict(pack_encoder=16, pack_decoder=16) if packed else {}
    batch = [torch.from_numpy(x) for x in _inputs(30, 8, jc)]
    results = []
    for accum in (1, 2):
        state, step = _port_state(params, **kw), _port_step(accum)
        for _ in range(2):
            state, m = step.step_on(state, *batch)
        results.append((m["loss"].item(), state.model.state_dict()))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for k, v in results[0][1].items():
        np.testing.assert_allclose(results[1][1][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5)


def test_accumulation_rejects_an_indivisible_batch(jax_params):
    jc, params = jax_params
    with pytest.raises(ValueError, match="divisible"):
        _port_step(accum=2).step_on(_port_state(params),
                                    *map(torch.from_numpy, _inputs(31, 3, jc)))


def _full_step_run(params, n_steps, seed):
    state, step = _port_state(params), _port_step()
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 3200))
                             .astype(np.float32))
    losses = []
    for i in range(n_steps):
        state, m = step(state, audio, torch.Generator().manual_seed(seed + i))
        losses.append(m["loss"].item())
    return state, losses


def test_loss_falls_over_twelve_steps(jax_params):
    _, losses = _full_step_run(jax_params[1], 12, seed=42)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_a_fixed_generator_gives_a_deterministic_step(jax_params):
    a, la = _full_step_run(jax_params[1], 2, seed=1)
    b, lb = _full_step_run(jax_params[1], 2, seed=1)
    assert la == lb
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.equal(next(a.teacher_encoder.parameters()), next(b.teacher_encoder.parameters()))


def test_teacher_moves_but_less_than_the_student(jax_params):
    params = jax_params[1]
    state, _ = _full_step_run(params, 4, seed=3)
    start = state_dict_from_jax_params(params)
    d_student = sum((v - start[f"encoder.{k}"]).abs().sum().item()
                    for k, v in state.model.encoder.state_dict().items())
    d_teacher = sum((v - start[f"encoder.{k}"]).abs().sum().item()
                    for k, v in state.teacher_encoder.state_dict().items())
    assert 0 < d_teacher < d_student


def test_schedules_match_jax():
    lr, jlr = warmup_cosine_schedule(4e-4, 100, 1000), jax_lr_schedule(4e-4, 100, 1000)
    ema, jema = ema_decay_schedule(0.999, 0.99999, 500), jax_ema_schedule(0.999, 0.99999, 500)
    # the JAX schedules run in f32: equal to f32 rounding of the peak
    for s in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 1500):
        np.testing.assert_allclose(lr(s), float(jlr(s)), rtol=1e-6, atol=4e-4 * 1e-7)
        np.testing.assert_allclose(ema(s), float(jema(s)), rtol=1e-7)


def test_canonicalisation_matches_the_jax_step():
    rng = np.random.default_rng(5)
    ctx = rng.random((6, 40)) < 0.3
    tgt = (rng.random((6, 3, 40)) < 0.2) & ctx[:, None, :]
    for chans, pe in ((1, 12), (2, 12)):
        c, v = canonicalize_for_packing(torch.from_numpy(ctx), torch.from_numpy(tgt), pe, chans)
        if chans > 1:
            vis = (~ctx).reshape(6, chans, -1)
            over = (np.cumsum(vis, axis=-1) > pe // chans).reshape(ctx.shape)
        else:
            over = np.cumsum(~ctx, axis=-1) > pe
        np.testing.assert_array_equal(c.numpy(), ctx | over)
        np.testing.assert_array_equal(v.numpy(), (ctx | over)[:, None, :] ^ tgt)
        # idempotent
        c2, _ = canonicalize_for_packing(c, torch.from_numpy(tgt), pe, chans)
        assert torch.equal(c2, c)
