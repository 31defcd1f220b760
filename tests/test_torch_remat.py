"""Recomputation (``trainer.remat*``, ``wavjepa_tpu_torch/ops/remat.py``) in
the port, at tests/test_torch_train_step.py's tiny size.

Against the JAX package, whose ``nn.remat`` replays the same layers: one
f32 step's loss and gradients at accum 1 and 2 on the mono model (packed),
the mono model with the fused predictor (the JAX Pallas kernel in interpret
mode, as tests/test_torch_fused_path.py runs it) and the WavJEPA-Nat model
(a conv stack a channel), every stack replayed on both sides; and the
denoise step at ``trainer.remat=true``, accum 1. Loss rtol 1e-5 and
gradient norm rtol 1e-4, as tests/test_torch_train_step.py; each gradient
leaf at rtol 1e-4 and atol 1e-6·‖g‖, the clip test's tolerance there
(atol 1e-9 at a clipped norm of 1e-3). Microbatches accumulate as the JAX
step's scan does (Σ∇num / Σden).

The port alone: with and without recomputation the loss and every
gradient are bit for bit equal on the CPU (the replay runs the same
operations on the same inputs), for each flag on its own, with
``remat_save_probs``, on the fused path and on Nat; the replay is real
(the bytes kept for the backward fall; the attention forward runs once more
a replayed layer in the backward, and not at all with
``remat_save_probs``); nothing is replayed without a gradient (serving, the
EMA teacher, a frozen teacher); the state-dict names do not change; and the
denoise student follows ``remat`` alone, as the JAX package's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api.convert import convert_jepa_state_dict as jax_convert_state_dict
from wavjepa_tpu.masking import TimeInverseMaskConfig as JaxMaskConfig
from wavjepa_tpu.masking import time_inverse_block_masks as jax_masks
from wavjepa_tpu.models.denoiser import DenoiserStudent as JaxStudent
from wavjepa_tpu.models.denoiser import denoiser_distillation_loss as jax_distillation_loss
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops.audio import instance_normalize as jax_instance_normalize
from wavjepa_tpu.train.step import jepa_loss_fn as jax_jepa_loss_fn
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.denoiser import DenoiserConfig, DenoiserStudent
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops import flash_attention as fa
from wavjepa_tpu_torch.ops import fused_attention_block as fab
from wavjepa_tpu_torch.ops import remat as remat_mod
from wavjepa_tpu_torch.train import config as tcfg
from wavjepa_tpu_torch.train.denoise_step import (
    DenoiseOptimizerConfig,
    DenoiseTrainState,
    make_denoise_optimizer,
    make_denoise_train_step,
)
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    OptimizerConfig,
    canonicalize_for_packing,
    jepa_loss_fn,
    make_jepa_train_step,
    make_optimizer,
)

# tests/test_torch_train_step.py's TINY and MASK
TINY = dict(
    conv_spec=((32, 10, 5), (32, 3, 2)), in_channels=1, encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=2, decoder_dim=16, decoder_heads=4, sample_rate=1600,
    process_seconds=0.201, average_top_k_layers=2,
)
MASK = dict(target_masks_per_context=2, context_mask_prob=0.5, context_mask_length=4,
            target_prob=0.2, target_length=4, ratio_cutoff=0.1)
FULL = dict(remat=True, remat_conv=True, remat_encoder=True, remat_decoder=True)
OFF = dict(remat=False)
# the three models held against the JAX package: (model fields, channels)
MODELS = {
    "mono_packed": (dict(pack_encoder=16, pack_decoder=24), 1),
    "fused_decoder": (dict(attn_impl_decoder="fused_block"), 1),
    "nat": (dict(in_channels=2, extractor="conv_channel", pos_embed="binaural"), 2),
}
ROWS = 2  # crops a microbatch


def _model(seed: int = 3, **kw) -> JEPA:
    model = JEPA(JEPAConfig(**{**TINY, **kw}))
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model


def _crops_and_masks(seed: int, n_rows: int, jc, channels: int):
    rng = np.random.default_rng(seed)
    crops = rng.standard_normal((n_rows, channels, jc.target_length)).astype(np.float32)
    crops = np.array(jax_instance_normalize(jnp.asarray(crops * 2 + 0.5)))
    mask_cfg = JaxMaskConfig(**MASK, channel_based_masking=channels > 1)
    ctx, tgt, vis = (np.array(m) for m in jax_masks(
        jax.random.PRNGKey(seed), batch_size=n_rows, n_times=jc.total_patches,
        in_channels=channels, cfg=mask_cfg))
    if jc.pack_encoder is not None:  # the step's canonicalisation, on both sides
        ctx, vis = (x.numpy() for x in canonicalize_for_packing(
            torch.from_numpy(ctx), torch.from_numpy(tgt), jc.pack_encoder, channels))
    return crops, ctx, tgt, vis


@pytest.fixture(scope="module", params=list(MODELS))
def jax_model(request):
    """A JAX model with every stack replayed, its weights, and its step's
    loss and gradients on 4 crops in 2 microbatches (accum 2) and on the
    first 2 (accum 1), accumulated as the JAX step does."""
    fields, channels = MODELS[request.param]
    jc = JaxConfig(**{**TINY, **fields}, **FULL)
    model = JaxJEPA(jc)
    params = _jax_params(_model(**fields))
    batch = _crops_and_masks(5, 2 * ROWS, jc, channels)

    @jax.jit
    def num_grad(p, *xs):  # one microbatch: (num, den) and ∇num
        (num, den), g = jax.value_and_grad(
            lambda q: jax_jepa_loss_fn(model, q, p["encoder"], *xs, return_terms=True),
            has_aux=True)(p)
        return num, den, g

    ref = {}
    for accum in (1, 2):
        g_sum, num_sum, den_sum = None, 0.0, 0.0
        for i in range(accum):
            num, den, g = num_grad(params, *(x[i * ROWS:(i + 1) * ROWS] for x in batch))
            g_sum = g if g_sum is None else jax.tree.map(jnp.add, g_sum, g)
            num_sum, den_sum = num_sum + num, den_sum + den
        inv = 1.0 / (den_sum + 1e-8)
        grads = state_dict_from_jax_params(jax.tree.map(lambda x: np.asarray(x * inv), g_sum))
        ref[accum] = (float(num_sum * inv), grads)
    return request.param, params, batch, ref


def _jax_params(model, with_decoder: bool = True) -> dict:
    """The JAX parameter tree of a port model's weights (the JAX package's
    own converter of reference state dicts)."""
    cfg = model.config
    params, _ = jax_convert_state_dict(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        conv_layers=len(cfg.conv_spec), mode=cfg.extractor_mode,
        channel_wise=cfg.extractor == "conv_channel", in_channels=cfg.in_channels,
        with_decoder=with_decoder)
    return params


def _port_grads(params, fields, batch, accum, **remat):
    """One ``step_on`` of the port at ``accum`` from the JAX weights; the
    gradients left in place (the optimizer's update skipped, no clip)."""
    model = JEPA(JEPAConfig(**{**TINY, **fields}, **remat))
    model.load_state_dict(state_dict_from_jax_params(params))
    opt = OptimizerConfig(grad_clip=1e9)
    state = TrainState.create(model, make_optimizer(opt, model))
    state.optimizer.step = lambda: None
    channels = model.config.in_channels
    step = make_jepa_train_step(opt, nr_samples_per_audio=2, accum_steps=accum,
                                masker_cfg=TimeInverseMaskConfig(
                                    **MASK, channel_based_masking=channels > 1))
    _, m = step.step_on(state, *(torch.from_numpy(x[:accum * ROWS]) for x in batch))
    return m, {k: p.grad.clone() for k, p in model.named_parameters()}


def _close_grads(got: dict, want: dict, g_norm: float):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6 * g_norm,
                                   err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_a_step_with_recomputation_matches_jax(jax_model, accum):
    name, params, batch, ref = jax_model
    loss, want = ref[accum]
    m, got = _port_grads(params, MODELS[name][0], batch, accum, **FULL)
    g_norm = float(np.sqrt(sum((w.double() ** 2).sum().item() for w in want.values())))
    np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), g_norm, rtol=1e-4)
    _close_grads(got, want, g_norm)


# ------------------------------------------------------- the port alone

SETTINGS = {
    "conv": dict(remat=False, remat_conv=True),
    "encoder": dict(remat=False, remat_encoder=True),
    "decoder": dict(remat=False, remat_decoder=True),
    "full": FULL,
    "full_save_probs": dict(FULL, remat_save_probs=True),
    "fused_full": dict(FULL, attn_impl="fused_block"),
    "fused_full_save_probs": dict(FULL, attn_impl="fused_block", remat_save_probs=True),
    "nat_full": dict(FULL, **MODELS["nat"][0]),
}


def _batch(cfg: JEPAConfig, rows: int = 4, seed: int = 7):
    g = torch.Generator().manual_seed(seed)
    crops = torch.randn(rows, cfg.in_channels, cfg.target_length, generator=g)
    ctx = torch.rand(rows, cfg.total_patches, generator=g) < 0.6
    tgt = (torch.rand(rows, 2, cfg.total_patches, generator=g) < 0.3) & ctx[:, None]
    return crops, ctx, tgt, ctx[:, None] ^ tgt


def _loss_and_grads(model: JEPA, batch) -> tuple:
    teacher = model.build_teacher_encoder()
    loss = jepa_loss_fn(model, teacher, *batch)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_recomputation_leaves_loss_and_gradients_bit_equal(setting):
    kw = SETTINGS[setting]
    base = {k: v for k, v in kw.items() if not k.startswith("remat")}
    plain, replayed = _model(**base, **OFF), _model(**kw)
    batch = _batch(plain.config)
    (loss_a, grads_a), (loss_b, grads_b) = (_loss_and_grads(m, batch) for m in (plain, replayed))
    assert torch.equal(loss_a, loss_b)
    assert grads_a.keys() == grads_b.keys()
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k


class _Counts:
    """Calls of the attention forwards' plain versions (what the kernels are
    on the CPU), split at the start of the backward."""

    def __init__(self, monkeypatch):
        self.n = 0
        for mod, name in ((fa, "flash_attention_reference"), (fab, "_reference_params")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, self._counted(fn))

    def _counted(self, fn):
        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        return counted


def _kept_bytes_and_forwards(monkeypatch, **kw) -> tuple[int, int, int]:
    """(bytes autograd keeps for the backward outside the replayed regions,
    attention forwards in the forward, in the backward) of one student
    pass."""
    counts = _Counts(monkeypatch)
    model = _model(**kw)
    crops, ctx, tgt, vis = _batch(model.config)
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        preds = model.student_forward(model.encode_features(crops), ctx, vis)
    forward = counts.n
    preds.square().mean().backward()
    return sum(kept), forward, counts.n - forward


@pytest.mark.parametrize("impl", ["auto", "fused_block"])
def test_the_replay_keeps_less_and_runs_the_attention_forward_again(monkeypatch, impl):
    enc, dec = TINY["encoder_layers"], TINY["decoder_layers"]
    runs = {name: _kept_bytes_and_forwards(monkeypatch, attn_impl=impl, **kw) for name, kw in (
        ("off", OFF), ("decoder", dict(remat=False, remat_decoder=True)), ("full", FULL),
        ("save_probs", dict(FULL, remat_save_probs=True)))}
    assert {name: run[1:] for name, run in runs.items()} == {
        "off": (enc + dec, 0), "decoder": (enc + dec, dec), "full": (enc + dec, enc + dec),
        "save_probs": (enc + dec, 0)}
    kept = {name: run[0] for name, run in runs.items()}
    assert kept["off"] > kept["save_probs"] > kept["full"]
    assert kept["off"] > kept["decoder"] > kept["full"]


def test_nothing_is_replayed_without_a_gradient(monkeypatch):
    calls = []
    checkpoint = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda *a, **kw: calls.append(1) or checkpoint(*a, **kw))
    model = _model(**FULL)
    crops, ctx, tgt, vis = _batch(model.config)
    with torch.no_grad():
        model.represent(crops)
    with torch.inference_mode():  # serving
        model.represent(crops)
    with torch.no_grad():
        feats = model.encode_features(crops)
    teacher = model.build_teacher_encoder()  # the EMA teacher, grad mode on
    teacher.layer_outputs(feats)
    frozen = _model(**FULL).requires_grad_(False)  # the frozen denoise teacher
    frozen.represent(crops)
    assert calls == []
    model.represent(crops)
    conv_blocks, layers = len(TINY["conv_spec"]), TINY["encoder_layers"]
    assert len(calls) == conv_blocks + 2 * layers  # a block each, two regions a layer


def test_preserving_the_rng_state_would_change_nothing(monkeypatch):
    batch = _batch(_model().config)
    torch.manual_seed(0)
    state = torch.get_rng_state()
    loss_a, grads_a = _loss_and_grads(_model(**FULL), batch)
    assert torch.equal(torch.get_rng_state(), state)  # the layers draw nothing
    checkpoint = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint", lambda *a, **kw: checkpoint(
        *a, **dict(kw, preserve_rng_state=True)))
    loss_b, grads_b = _loss_and_grads(_model(**FULL), batch)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)


def test_state_dict_names_do_not_change():
    names = set(state_dict_from_jax_params(_jax_params(_model(**OFF))))
    for kw in (OFF, FULL, dict(FULL, remat_save_probs=True)):
        assert set(JEPA(JEPAConfig(**TINY, **kw)).state_dict()) == names
    assert not any("checkpoint" in k for k in names)


def _jax_flags(module, fields: tuple) -> dict:
    """The recomputation fields of a bound JAX module's submodules."""
    return {f"{sub}.{f}": getattr(getattr(module, sub), f) for sub, f in fields}


def _port_flags(module, fields: tuple) -> dict:
    def read(sub, f):
        m = getattr(module, sub)
        return m.remat if sub == "extract_audio" else getattr(m.layers[0], f)
    return {f"{sub}.{f}": read(sub, f) for sub, f in fields}


STUDENT_FIELDS = (("extract_audio", "remat"), ("encoder", "remat"),
                  ("encoder", "remat_save_probs"))


@pytest.mark.parametrize("flags", [
    dict(remat=True, remat_conv=False, remat_encoder=False, remat_save_probs=True),
    dict(remat=False, remat_conv=True, remat_encoder=True),
])
def test_the_denoise_student_follows_remat_alone(flags):
    cfg = JEPAConfig(**TINY, **flags)
    jstudent = JaxStudent(JaxConfig(**TINY, **flags)).bind({})
    want = _jax_flags(jstudent, STUDENT_FIELDS)
    assert _port_flags(DenoiserStudent(cfg), STUDENT_FIELDS) == want == {
        "extract_audio.remat": cfg.remat, "encoder.remat": cfg.remat,
        "encoder.remat_save_probs": False}
    # JEPA's own rule differs: the per-stack overrides win
    jepa = _port_flags(JEPA(cfg), STUDENT_FIELDS)
    assert jepa == {"extract_audio.remat": cfg.remat_conv,
                    "encoder.remat": cfg.remat_encoder,
                    "encoder.remat_save_probs": cfg.remat_save_probs}


DENOISE_TINY = dict(conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
                    encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
                    sample_rate=1600, process_seconds=0.201, average_top_k_layers=2)


def test_the_denoise_step_with_remat_matches_jax():
    resolved = tcfg.apply_overrides(tcfg.Config(), ["trainer.remat=true",
                                                    "trainer.accum_steps=1"]
                                    ).build_denoise_model_config()
    remat = {f: getattr(resolved, f) for f in ("remat", "remat_conv", "remat_encoder",
                                               "remat_decoder", "remat_save_probs")}
    assert remat["remat"] is True
    jc = JaxConfig(**DENOISE_TINY, **remat)
    cfg = JEPAConfig(**DENOISE_TINY, **remat)
    teacher, seeded = JEPA(cfg), JEPA(cfg)  # the student initialised apart
    teacher.init_parameters(torch.Generator().manual_seed(0))
    seeded.init_parameters(torch.Generator().manual_seed(9))
    tparams, sparams = _jax_params(teacher), _jax_params(seeded, with_decoder=False)
    rng = np.random.default_rng(4)
    clean, noisy = (np.array(jax_instance_normalize(jnp.asarray(
        rng.standard_normal((4, 1, jc.target_length)).astype(np.float32)))) for _ in range(2))
    alpha = 0.3

    def loss_fn(params):
        targets = JaxJEPA(jc).apply({"params": tparams}, clean, method="represent")
        student = JaxStudent(jc)
        return jax_distillation_loss(student.apply({"params": params}, clean),
                                     student.apply({"params": params}, noisy), targets,
                                     alpha)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sparams)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))

    teacher.requires_grad_(False)
    student = DenoiserStudent(cfg)
    student.load_state_dict(state_dict_from_jax_params(sparams))
    assert student.extract_audio.remat and student.encoder.layers[0].remat
    opt = DenoiseOptimizerConfig(grad_clip=1e9)
    state = DenoiseTrainState(student, make_denoise_optimizer(opt, student))
    state.optimizer.step = lambda: None
    step = make_denoise_train_step(opt, DenoiserConfig(jepa=cfg, alpha=alpha), with_rir=True,
                                   with_noise=True, accum_steps=1)
    _, m = step.step_on(state, teacher, torch.from_numpy(clean), torch.from_numpy(noisy))
    got = {k: p.grad for k, p in student.named_parameters()}
    g_norm = float(np.sqrt(sum((w.double() ** 2).sum().item() for w in want.values())))
    np.testing.assert_allclose(m["loss"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), g_norm, rtol=1e-4)
    _close_grads(got, want, g_norm)


def test_flags_round_trip_through_the_model_config():
    cfg = dataclasses.replace(JEPAConfig(**TINY), **FULL, remat_save_probs=True)
    model = JEPA(cfg)
    assert model.extract_audio.remat
    assert all(layer.remat and layer.remat_save_probs
               for stack in (model.encoder, model.decoder) for layer in stack.layers)
