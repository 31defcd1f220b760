"""The ``attn_impl="fused_block"`` path of the port against the JAX
package's, which runs its Pallas kernel in interpret mode on the CPU: the
attention module and the encoder, the student with the decoder-only
override (unpacked and packed), one whole train step with every stack
fused, and the config field that selects it. Weights come from the JAX
init through ``state_dict_from_jax_params``; inputs and masks are numpy.

f32 throughout. Modules: atol and rtol 2e-5, as
tests/test_fused_attention_block.py's encoder test; the student: 2e-4, as its
decoder-override test; the step: the tolerances of
tests/test_torch_train_step.py."""

import dataclasses

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
from wavjepa_tpu.ops.transformer import MultiHeadSelfAttention as JaxAttention
from wavjepa_tpu.ops.transformer import TransformerEncoder as JaxEncoder
from wavjepa_tpu.train import config as jcfg
from wavjepa_tpu.train.state import TrainState as JaxTrainState
from wavjepa_tpu.train.state import ema_update as jax_ema_update
from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from wavjepa_tpu.train.step import jepa_loss_fn as jax_jepa_loss_fn
from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.train import config as tcfg
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    EMAConfig,
    OptimizerConfig,
    make_jepa_train_step,
    make_optimizer,
)

MOD_TOL, STUDENT_TOL = 2e-5, 2e-4
# tests/test_fused_attention_block.py's decoder-override model: 160 tokens,
# encoder 2 × 64 (4 heads), predictor 2 × 32 (4 heads)
BASE = dict(
    conv_spec=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_layers=2, encoder_dim=64,
    encoder_heads=4, decoder_layers=2, decoder_dim=32, decoder_heads=4, sample_rate=16000,
    process_seconds=0.201, average_top_k_layers=2,
)
PACK = dict(pack_encoder=96, pack_decoder=156)


@pytest.fixture(scope="module")
def setup():
    jc = JaxConfig(**BASE, remat=False)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((3, 1, jc.target_length)).astype(np.float32)
    params = jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))
    params = jax.tree.map(np.asarray, params["params"])
    # non-zero biases, so a misplaced one shows
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    ctx, tgt, _ = jax_masks(jax.random.PRNGKey(1), batch_size=3, n_times=jc.total_patches,
                            cfg=JaxMaskConfig())
    ctx = ctx | (jnp.cumsum(~ctx, axis=-1) > PACK["pack_encoder"])  # the step's canonicalisation
    vis = jnp.logical_xor(ctx[:, None, :], tgt)
    encode = jax.jit(lambda p, a: JaxJEPA(jc).apply({"params": p}, a, method="encode_features"))
    feats = np.asarray(encode(params, jnp.asarray(audio)))
    return params, np.array(ctx), np.array(vis), feats


def _port(params, **kw):
    model = JEPA(JEPAConfig(**BASE, **kw))
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _key_mask(feats, seed):
    mask = np.random.default_rng(seed).random(feats.shape[:2]) < 0.3
    mask[0] = True  # a fully masked row
    return mask


def test_attention_module_matches_jax(setup):
    params, _, _, feats = setup
    mask = _key_mask(feats, 1)
    jattn = JaxAttention(64, 4, attn_impl="fused_block")
    ref = jattn.apply({"params": params["encoder"]["layers_0"]["self_attn"]},
                      jnp.asarray(feats), key_padding_mask=jnp.asarray(mask))
    attn = _port(params, attn_impl="fused_block").encoder.layers[0].self_attn
    assert attn.attn_impl == "fused_block"
    out = attn(torch.tensor(feats), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=MOD_TOL, atol=MOD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_jax(setup, masked):
    params, _, _, feats = setup
    mask = _key_mask(feats, 2) if masked else None
    jenc = JaxEncoder(num_layers=2, embed_dim=64, num_heads=4, mlp_dim=256,
                      attn_impl="fused_block")
    ref = jenc.apply({"params": params["encoder"]}, jnp.asarray(feats),
                     None if mask is None else jnp.asarray(mask))
    port = _port(params, attn_impl="fused_block")
    out = port.encoder(torch.from_numpy(feats), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=MOD_TOL, atol=MOD_TOL)


def test_fused_and_default_paths_share_parameters(setup):
    params = setup[0]
    fused, default = _port(params, attn_impl="fused_block"), _port(params)
    assert fused.decoder.layers[0].self_attn.attn_impl == "fused_block"
    assert default.encoder.layers[0].self_attn.attn_impl == "auto"
    sd_f, sd_d = fused.state_dict(), default.state_dict()
    assert list(sd_f) == list(sd_d)
    assert all(sd_f[k].shape == sd_d[k].shape and torch.equal(sd_f[k], sd_d[k]) for k in sd_f)
    # a state_dict of one path loads into the other
    JEPA(JEPAConfig(**BASE)).load_state_dict(sd_f)
    JEPA(JEPAConfig(**BASE, attn_impl="fused_block")).load_state_dict(sd_d)


def test_decoder_override_and_the_teacher_follow_the_config(setup):
    port = _port(setup[0], attn_impl_decoder="fused_block")
    impls = lambda enc: {layer.self_attn.attn_impl for layer in enc.layers}
    assert impls(port.encoder) == {"auto"} and impls(port.decoder) == {"fused_block"}
    assert impls(port.build_teacher_encoder()) == {"auto"}
    fused = _port(setup[0], attn_impl="fused_block")
    assert impls(fused.decoder) == impls(fused.build_teacher_encoder()) == {"fused_block"}


@pytest.mark.parametrize("packed", [False, True])
def test_student_with_the_decoder_override_matches_jax(setup, packed):
    params, ctx, vis, feats = setup
    kw = dict(attn_impl_decoder="fused_block", **(PACK if packed else {}))
    jm = JaxJEPA(JaxConfig(**BASE, remat=False, attn_impl="einsum", **kw))
    student = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method="student_forward"))
    ref = np.asarray(student(params, *map(jnp.asarray, (feats, ctx, vis))))
    out = _port(params, **kw).student_forward(*map(torch.from_numpy, (feats, ctx, vis)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=STUDENT_TOL, atol=STUDENT_TOL)


# tests/test_torch_train_step.py's tiny model, masker and optimizer
TINY = dict(
    conv_spec=((32, 10, 5), (32, 3, 2)), in_channels=1, encoder_layers=2, encoder_dim=32,
    encoder_heads=4, decoder_layers=2, decoder_dim=16, decoder_heads=4, sample_rate=1600,
    process_seconds=0.201, average_top_k_layers=2,
)
MASK = dict(target_masks_per_context=2, context_mask_prob=0.5, context_mask_length=4,
            target_prob=0.2, target_length=4, ratio_cutoff=0.1)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
EMA_END = 50


def test_one_fused_train_step_matches_jax():
    jc = JaxConfig(**TINY, attn_impl="fused_block", remat=False)
    # the einsum path declares the same parameters and initialises faster
    init = jax.jit(JaxJEPA(dataclasses.replace(jc, attn_impl="einsum")).init)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 1, jc.target_length)))["params"])
    rng = np.random.default_rng(10)
    crops = rng.standard_normal((4, 1, jc.target_length)).astype(np.float32) * 2 + 0.5
    crops = np.array(jax_instance_normalize(jnp.asarray(crops)))
    masks = [np.array(m) for m in jax_masks(jax.random.PRNGKey(10), batch_size=4,
                                            n_times=jc.total_patches, cfg=JaxMaskConfig(**MASK))]

    # JAX: value_and_grad of jepa_loss_fn, the optax update, the EMA (the
    # teacher starts as the student encoder), in one compiled function
    tx, sched = jax_make_optimizer(JaxOptimizerConfig(**OPT))

    @jax.jit
    def jax_step(params, *batch):
        state = JaxTrainState.create(params, tx)
        loss, grads = jax.value_and_grad(jax_jepa_loss_fn, argnums=1)(
            JaxJEPA(jc), state.params, state.teacher_encoder, *batch)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        teacher = jax_ema_update(state.teacher_encoder, state.params["encoder"], 0.999)
        return loss, optax.global_norm(grads), optax.apply_updates(state.params, updates), teacher

    loss, grad_norm, new_params, teacher = jax_step(params, *map(jnp.asarray, (crops, *masks)))
    ref_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, new_params),
                                        teacher_encoder=jax.tree.map(np.asarray, teacher))

    model = JEPA(JEPAConfig(**TINY, attn_impl="fused_block"))
    model.load_state_dict(state_dict_from_jax_params(params))
    tstate = TrainState.create(model, make_optimizer(OptimizerConfig(**OPT), model))
    step = make_jepa_train_step(OptimizerConfig(**OPT), nr_samples_per_audio=2,
                                masker_cfg=TimeInverseMaskConfig(**MASK),
                                ema_cfg=EMAConfig(anneal_end_step=EMA_END))
    tstate, m = step.step_on(tstate, *map(torch.from_numpy, (crops, *masks)))
    np.testing.assert_allclose(m["loss"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(grad_norm), rtol=1e-4)
    np.testing.assert_allclose(m["lr"], float(sched(0)), rtol=1e-6)
    for k, v in tstate.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=2e-6, rtol=1e-4, err_msg=k)
    for k, v in tstate.teacher_encoder.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[f"teacher_encoder.{k}"].numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=k)


def test_config_selects_the_fused_path_in_both_packages():
    over = ["trainer.attn_impl_decoder=fused_block"]
    tc = tcfg.apply_overrides(tcfg.Config(), over)
    jc = jcfg.apply_overrides(jcfg.Config(), over)
    assert tc.trainer.attn_impl_decoder == jc.trainer.attn_impl_decoder == "fused_block"
    tm, jm = tc.build_model_config(), jc.build_model_config()
    assert (tm.attn_impl, tm.attn_impl_decoder) == (jm.attn_impl, jm.attn_impl_decoder) \
        == ("auto", "fused_block")
    assert dataclasses.replace(tm, attn_impl_decoder=None) == tcfg.Config().build_model_config()
    whole = tcfg.apply_overrides(tcfg.Config(), ["trainer.attn_impl=fused_block"])
    assert whole.build_model_config().attn_impl == "fused_block"
