"""The training side of the port's JEPA against the JAX package's: the
student (unpacked and packed), the teacher's targets, both losses and their
gradients, with weights carried across by ``state_dict_from_jax_params``
and masks made by the JAX masker, handed over as numpy arrays.

f32 throughout. Outputs: atol 5e-5, rtol 1e-4, as tests/test_torch_model.py
(two post-norm layers on top of the frontend compound the op error). Loss
terms: rtol 1e-5 (one f32 reduction in another order). Gradients: atol
5e-5, rtol 1e-3, the attention-gradient tolerance, through two stacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.api.convert import export_jepa_state_dict
from wavjepa_tpu.masking import TimeInverseMaskConfig, time_inverse_block_masks
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.models.jepa import masked_prediction_loss as jax_masked_loss
from wavjepa_tpu.train.state import TrainState as JaxTrainState
from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig, masked_prediction_loss

ATOL, RTOL = 5e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-3
# tests/test_packing.py's BASE: 160 tokens under the AudioSet masker
BASE = dict(
    conv_spec=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_layers=2, encoder_dim=64,
    encoder_heads=4, decoder_layers=2, decoder_dim=32, decoder_heads=4, sample_rate=16000,
    process_seconds=0.201, average_top_k_layers=2,
)
PACK = dict(pack_encoder=96, pack_decoder=156)


@pytest.fixture(scope="module")
def setup():
    jc = JaxConfig(**BASE, remat=False)
    t = jc.total_patches
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((4, 1, jc.target_length)).astype(np.float32)
    params = JaxJEPA(jc).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, jc.target_length)))
    params = jax.tree.map(np.asarray, params["params"])
    ctx, tgt, _ = time_inverse_block_masks(jax.random.PRNGKey(1), batch_size=4, n_times=t,
                                           cfg=TimeInverseMaskConfig())
    ctx = ctx | (jnp.cumsum(~ctx, axis=-1) > PACK["pack_encoder"])  # the step's canonicalisation
    vis = jnp.logical_xor(ctx[:, None, :], tgt)
    masks = tuple(np.array(m) for m in (ctx, tgt, vis))
    feats = np.asarray(JaxJEPA(jc).apply({"params": params}, jnp.asarray(audio),
                                         method="encode_features"))
    return params, audio, masks, feats


def _port(params, **kw):
    model = JEPA(JEPAConfig(**BASE, **kw))
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _jax(**kw):
    return JaxJEPA(JaxConfig(**BASE, remat=False, **kw))


@pytest.mark.parametrize("packed", [False, True])
def test_student_forward_matches_jax(setup, packed):
    params, audio, (ctx, _, vis), feats = setup
    kw = PACK if packed else {}
    ref = np.asarray(_jax(**kw).apply({"params": params}, jnp.asarray(feats), jnp.asarray(ctx),
                                      jnp.asarray(vis), method="student_forward"))
    port = _port(params, **kw)
    tfeats = port.encode_features(torch.from_numpy(audio))
    np.testing.assert_allclose(tfeats.detach().numpy(), feats, atol=ATOL, rtol=RTOL)
    out = port.student_forward(torch.from_numpy(feats), torch.from_numpy(ctx),
                               torch.from_numpy(vis)).detach().numpy()
    assert out.shape == ref.shape == (4, 4, 160, 64)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_packed_equals_unpacked_at_targets(setup):
    params, _, (ctx, tgt, vis), feats = setup
    args = [torch.from_numpy(x) for x in (feats, ctx, vis)]
    full = _port(params).student_forward(*args).detach().numpy()
    packed = _port(params, **PACK).student_forward(*args).detach().numpy()
    np.testing.assert_allclose(packed[tgt], full[tgt], atol=2e-5, rtol=1e-4)
    # outside each group's pack the packed path writes zeros
    assert (packed[~(~vis)] == 0).all()


def test_teacher_forward_matches_jax_with_a_teacher_tree(setup):
    params, _, _, feats = setup
    teacher = jax.tree.map(lambda x: x * 0.9, params["encoder"])
    ref = np.asarray(_jax().apply({"params": {**params, "encoder": teacher}},
                                  jnp.asarray(feats), method="teacher_forward"))
    port = _port(params)
    t_enc = port.build_teacher_encoder()
    sd = state_dict_from_jax_params(params, teacher_encoder=teacher)
    t_enc.load_state_dict({k.removeprefix("teacher_encoder."): v for k, v in sd.items()
                           if k.startswith("teacher_encoder.")})
    assert not any(p.requires_grad for p in t_enc.parameters())
    out = port.teacher_forward(torch.from_numpy(feats), t_enc).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # instance-normed per layer: mean 0 and unit variance over (T, D) per layer, averaged
    assert abs(out.mean()) < 1e-5


def test_masked_prediction_loss_matches_jax():
    rng = np.random.default_rng(3)
    preds = rng.standard_normal((2, 3, 20, 8)).astype(np.float32)
    targets = rng.standard_normal((2, 20, 8)).astype(np.float32)
    w = rng.random((2, 3, 20)) < 0.3
    ref = [float(x) for x in jax_masked_loss(*map(jnp.asarray, (preds, targets, w)), True)]
    out = [float(x) for x in masked_prediction_loss(*map(torch.from_numpy, (preds, targets, w)),
                                                    return_terms=True)]
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    np.testing.assert_allclose(
        float(masked_prediction_loss(*map(torch.from_numpy, (preds, targets, w)))),
        float(jax_masked_loss(*map(jnp.asarray, (preds, targets, w)))), rtol=1e-5)


def test_packed_prediction_loss_and_its_gradients_match_jax(setup):
    params, _, (ctx, tgt, vis), feats = setup
    jm = _jax(**PACK)
    targets = np.asarray(jm.apply({"params": params}, jnp.asarray(feats),
                                  method="teacher_forward"))
    j_args = tuple(map(jnp.asarray, (feats, ctx, vis, targets, tgt)))

    def num(p):
        n, d = jm.apply({"params": p}, *j_args, method="packed_prediction_loss",
                        return_terms=True)
        return n, d

    (ref_num, ref_den), ref_grads = jax.value_and_grad(num, has_aux=True)(params)
    port = _port(params, **PACK)
    t_args = [torch.from_numpy(x) for x in (feats, ctx, vis, targets, tgt)]
    n, d = port.packed_prediction_loss(*t_args, return_terms=True)
    n.backward()
    np.testing.assert_allclose([n.item(), d.item()], [float(ref_num), float(ref_den)], rtol=1e-5)
    ref_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, ref_grads))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(ref_sd)
    # the frontend is not in this loss's graph (the features come in as an
    # input); the encoder, decoder, mappers and mask token are
    for k, g in grads.items():
        if g is None:
            assert not ref_sd[k].abs().max() > 0, k
            continue
        np.testing.assert_allclose(g.numpy(), ref_sd[k].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    assert grads["mask_token"] is not None and grads["mask_token"].abs().max() > 0


def test_weights_carried_across_with_the_teacher():
    jc = JaxConfig(**BASE, remat=False)
    params = JaxJEPA(jc).init(jax.random.PRNGKey(2), jnp.zeros((1, 1, jc.target_length)))
    tx, _ = jax_make_optimizer(JaxOptimizerConfig())
    state = JaxTrainState.create(params["params"], tx)
    teacher = jax.tree.map(lambda x: np.asarray(x) * 0.5, state.teacher_encoder)
    ref = export_jepa_state_dict(state.params, teacher_encoder=teacher)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params),
                                    teacher_encoder=teacher)
    assert set(sd) == set(ref)
    assert any(k.startswith("teacher_encoder.layers.1.") for k in sd)
    for k, v in sd.items():
        assert tuple(v.shape) == np.shape(ref[k]), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    # and the port's modules take them: the student, then the teacher encoder
    port = JEPA(JEPAConfig(**BASE))
    port.load_state_dict({k: v for k, v in sd.items() if not k.startswith("teacher_encoder.")})
    t_enc = port.build_teacher_encoder()
    t_enc.load_state_dict({k.removeprefix("teacher_encoder."): v for k, v in sd.items()
                           if k.startswith("teacher_encoder.")})
