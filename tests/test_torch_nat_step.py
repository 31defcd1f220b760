"""The WavJEPA-Nat train step in the port against the JAX package's, on one
scene batch from seeded numpy: the scenes (synthesis, then 3.2 kHz →
1.6 kHz) and the crops at the JAX step's own offsets equal to the JAX
package's; then ``step_on`` from those crops with the JAX masker's
channel-based masks against the JAX step's loss and gradient norm (loss
rtol 1e-5, gradient norm rtol 1e-4, as tests/test_torch_train_step.py).
Then the port alone: the inline batch against the banked, int16-wired one
(rtol 2e-3, as tests/test_train_step.py); the bank refresh applied after
the step that consumed its batch; the Nat configuration as the JAX package
resolves it; the CLI on it at tiny size, its last checkpoint served by
``api/hear_natjepa``. Each at 2 channels (binaural positions) and at 4
(ambisonic: ``data.in_channels=4 extractor.pos_embed=time``, the binaural
table being 2·T rows)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.data.pipeline import quantize_clip_int16
from wavjepa_tpu.data.resample import resample_jax
from wavjepa_tpu.masking import TimeInverseMaskConfig as JaxMaskConfig
from wavjepa_tpu.masking import time_inverse_block_masks as jax_masks
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops.audio import random_crops as jax_random_crops
from wavjepa_tpu.ops.scenes import generate_scene as jax_generate_scene
from wavjepa_tpu.train import config as jconfig
from wavjepa_tpu.train.state import TrainState as JaxTrainState
from wavjepa_tpu.train.step import NatSceneConfig as JaxNatSceneConfig
from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from wavjepa_tpu.train.step import make_jepa_train_step as jax_make_step
from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
from wavjepa_tpu.utils.flops import jepa_step_flops as jax_step_flops
from wavjepa_tpu_torch.api import hear_natjepa
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops.audio import crops_at, instance_normalize
from wavjepa_tpu_torch.ops.scenes import update_rir_bank
from wavjepa_tpu_torch.train import __main__ as cli
from wavjepa_tpu_torch.train.checkpoint import read_model_config
from wavjepa_tpu_torch.train.config import Config, apply_overrides, load_config
from wavjepa_tpu_torch.train.loop import run_step, scene_config
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    NatSceneConfig,
    OptimizerConfig,
    make_jepa_train_step,
    make_optimizer,
)
from wavjepa_tpu_torch.utils.flops import jepa_step_flops

TINY = dict(
    conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32, encoder_heads=4,
    decoder_layers=1, decoder_dim=16, decoder_heads=4, sample_rate=1600,
    process_seconds=0.201, average_top_k_layers=2, in_channels=2, extractor="conv_channel",
    pos_embed="binaural",
)
MASK = dict(target_masks_per_context=2, context_mask_prob=0.5, context_mask_length=4,
            target_prob=0.2, target_length=4, channel_based_masking=True)
OPT = dict(warmup_steps=2, total_steps=10)
SCENE = dict(n_channels=2, original_sr=3200)
B, T32, RIR = 2, 3200, 320
# (channels, positions): binaural, and ambisonic with the 1-D time table
CHANNELS = [pytest.param(2, "binaural", id="binaural"), pytest.param(4, "time", id="ambisonic")]
# the CLI's overrides of configs/nat_binaural.yaml for each case
CHANNEL_OVERRIDES = {2: [], 4: ["data.in_channels=4", "extractor.pos_embed=time"]}


def _tiny(channels):
    return {**TINY, "in_channels": channels,
            "pos_embed": "binaural" if channels == 2 else "time"}


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


@pytest.fixture(scope="module", params=[pytest.param(p.values, id=p.id) for p in CHANNELS])
def jax_side(request):
    channels, pos_embed = request.param
    tiny = _tiny(channels)
    assert tiny["pos_embed"] == pos_embed
    jc = JaxConfig(**tiny)
    model = JaxJEPA(jc)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, channels, jc.target_length)))
    params = jax.tree.map(np.asarray, params["params"])
    return jc, model, params


def _port_state(params, channels=2):
    model = JEPA(JEPAConfig(**_tiny(channels)))
    model.load_state_dict(state_dict_from_jax_params(params))
    return TrainState.create(model, make_optimizer(OptimizerConfig(**OPT), model))


def _port_step(channels=2):
    return make_jepa_train_step(OptimizerConfig(**OPT), nr_samples_per_audio=2,
                                masker_cfg=TimeInverseMaskConfig(**MASK),
                                scene_cfg=NatSceneConfig(**{**SCENE, "n_channels": channels}))


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_nat_step_matches_jax_on_one_scene_batch(jax_side):
    jc, model, params = jax_side
    c = jc.in_channels
    batch = _scene_batch(channels=c)
    tx, sched = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    jstep = jax_make_step(model, tx, sched, nr_samples_per_audio=2,
                          masker_cfg=JaxMaskConfig(**MASK),
                          scene_cfg=JaxNatSceneConfig(**{**SCENE, "n_channels": c}),
                          donate=False)
    rng = jax.random.PRNGKey(7)
    _, ref = jstep(JaxTrainState.create(params, tx), {k: jnp.asarray(v) for k, v in
                                                      batch.items()}, rng)

    # the JAX step's scenes, crop offsets and masks, computed as it does
    scene_ref = jax_generate_scene(
        batch["audio"], batch["source_rir"], batch["noise"], batch["noise_rirs"],
        batch["noise_start"], batch["noise_length"], batch["snr"], with_rir=True,
        with_noise=True, n_channels=c)
    scene_ref = resample_jax(scene_ref, 3200, 1600)
    k_crop, k_mask = jax.random.split(jax.random.fold_in(rng, 0))
    crop_len = jc.target_length
    starts = jax.random.randint(k_crop, (B, 2), 0, scene_ref.shape[-1] - crop_len + 1)
    crops_ref = jax_random_crops(k_crop, scene_ref, crop_len, 2)
    masks = jax_masks(k_mask, batch_size=2 * B, n_times=jc.total_patches, in_channels=c,
                      cfg=JaxMaskConfig(**MASK))

    state, step = _port_state(params, c), _port_step(c)
    scene = step.scenes(state.model.config, _tensors(batch))
    assert scene.shape == scene_ref.shape == (B, c, 1600)
    np.testing.assert_allclose(scene.numpy(), np.asarray(scene_ref), atol=1e-3, rtol=1e-4)
    crops = crops_at(scene, torch.from_numpy(np.array(starts)), crop_len)
    np.testing.assert_allclose(crops.numpy(), np.asarray(crops_ref), atol=1e-3, rtol=1e-4)

    crops = instance_normalize(crops, dims=(-2, -1)).reshape(2 * B, c, crop_len)
    state, m = step.step_on(state, crops, *(torch.from_numpy(np.array(x)) for x in masks))
    np.testing.assert_allclose(m["loss"].item(), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-4)


def test_inline_and_banked_int16_batches_give_the_same_step(jax_side):
    jc, _, params = jax_side
    c = jc.in_channels
    batch = _scene_batch(1, channels=c)
    rng = np.random.default_rng(3)
    bank = {"source_rir": rng.standard_normal((4, c, RIR)).astype(np.float32),
            "noise_rirs": rng.standard_normal((4, 3, c, RIR)).astype(np.float32),
            "noise": np.zeros((3, T32), np.int16)}
    idx, nidx = np.array([2, 0], np.int32), np.array([1, 2], np.int32)
    bank["source_rir"][idx] = batch["source_rir"]
    bank["noise_rirs"][idx] = batch["noise_rirs"]
    # the bank's noise rows left-aligned; the batch places them at noise_start
    for j, i in zip(nidx, range(B)):
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
    step = _port_step(c)
    losses = []
    for b, rir_bank in ((batch, None), (banked, {k: torch.from_numpy(v) for k, v in
                                                 bank.items()})):
        state = _port_state(params, c)
        _, m = step(state, _tensors(b), torch.Generator().manual_seed(5), rir_bank)
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-3)


def test_a_refresh_is_applied_after_the_step_that_consumed_its_batch():
    """A clip whose bank indices name slots its own batch's refresh
    replaces reads the rows its draw saw (the pre-refresh rows, which its
    noise_start and noise_length were drawn for); the refresh is in the
    bank afterwards. Applied before the step, as the JAX package's loop
    does, the scene comes out different."""
    rng = np.random.default_rng(8)
    cfg = JEPAConfig(**TINY)
    step = _port_step()
    bank = {"source_rir": torch.from_numpy(rng.standard_normal((3, 2, RIR)).astype(np.float32)),
            "noise_rirs": torch.from_numpy(
                rng.standard_normal((3, 3, 2, RIR)).astype(np.float32)),
            "noise": torch.from_numpy(np.stack([quantize_clip_int16(r) for r in
                                                rng.standard_normal((3, T32))]))}
    before = {k: v.clone() for k, v in bank.items()}
    refresh = {"slots": {"source_rir": torch.tensor([1]), "noise_rirs": torch.tensor([1]),
                         "noise": torch.tensor([2])},
               "rows": {"source_rir": torch.randn(1, 2, RIR), "noise_rirs": torch.randn(1, 3, 2, RIR),
                        "noise": torch.from_numpy(quantize_clip_int16(
                            rng.standard_normal((1, T32)).astype(np.float32)))}}
    batch = _tensors({"audio": rng.standard_normal((B, T32)).astype(np.float32),
                      "rir_index": np.array([1, 0], np.int32),
                      "noise_index": np.array([2, 0], np.int32),
                      "noise_start": np.array([10, 0], np.int32),
                      "noise_length": np.array([1500, T32], np.int32),
                      "snr": np.array([0.0, 1.0], np.float32)})
    expected = step.scenes(cfg, batch, before)
    seen = {}

    def step_fn(state, b, generator, rir_bank):
        seen["scene"] = step.scenes(cfg, b, rir_bank)
        return state, {}

    run_step(step_fn, None, {**batch, "rir_bank_refresh": copy.deepcopy(refresh)}, None, bank)
    torch.testing.assert_close(seen["scene"], expected, rtol=0, atol=0)
    for key, rows in refresh["rows"].items():
        slot = refresh["slots"][key]
        assert torch.equal(bank[key][slot], rows)
    jax_order = update_rir_bank({k: v.clone() for k, v in before.items()},
                                refresh["slots"], refresh["rows"])
    assert not torch.allclose(step.scenes(cfg, batch, jax_order), expected)


# each case's resolution of configs/nat_binaural.yaml (with its overrides):
# packing, tokens, microbatches, and the useful TFLOP of a 256-crop step
RESOLVED = {2: ((176, 256), 400, 16, 95.61), 4: ((352, 512), 800, 16, 203.41)}


@pytest.mark.parametrize("channels, pos_embed", CHANNELS)
def test_nat_config_resolves_as_the_jax_package(channels, pos_embed):
    items = CHANNEL_OVERRIDES[channels]
    pack, tokens, accum, tflop = RESOLVED[channels]
    cfg = apply_overrides(load_config("configs/nat_binaural.yaml"), items)
    jcfg = jconfig.apply_overrides(jconfig.load_config("configs/nat_binaural.yaml"), items)
    for c, m in ((cfg, cfg.build_model_config()), (jcfg, jcfg.build_model_config())):
        assert (m.pack_encoder, m.pack_decoder) == pack
        assert c.resolved_accum_steps() == accum
        assert (m.extractor, m.in_channels, m.pos_embed, m.total_patches) == (
            "conv_channel", channels, pos_embed, tokens)
        # packing turns the frontend's and the encoder's replay off, and
        # microbatching the predictor's
        assert (m.remat_conv, m.remat_encoder, m.remat_decoder) == (False, False, False)
    flop = jepa_step_flops(cfg.build_model_config(), 256)
    assert flop == jax_step_flops(jcfg.build_model_config(), 256)
    assert flop / 1e12 == pytest.approx(tflop, abs=5e-3)
    assert scene_config(cfg) == NatSceneConfig(with_rir=True, with_noise=True,
                                                n_channels=channels, original_sr=32000)
    jscene = JaxNatSceneConfig(n_channels=jcfg.data.in_channels)
    assert (jscene.n_channels, jscene.original_sr) == (channels, 32000)
    assert scene_config(Config()) is None


@pytest.mark.parametrize("channels, pos_embed", CHANNELS)
def test_cli_trains_the_nat_configuration_on_the_cpu(tmp_path, capsys, channels, pos_embed):
    cli.main(["configs/nat_binaural.yaml", *CHANNEL_OVERRIDES[channels], "trainer.size=tiny",
              "trainer.steps=2", "trainer.batch_size=2", "data.samples_per_audio=2",
              "trainer.log_every=1", "data.process_seconds=0.201", "data.target_seconds=0.5",
              f"trainer.save_dir={tmp_path}", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("[step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpts = list(tmp_path.rglob("step_00000002.ckpt"))
    assert len(ckpts) == 1
    sidecar = read_model_config(ckpts[0].parent.parent)
    assert (sidecar.extractor, sidecar.in_channels, sidecar.pos_embed) == (
        "conv_channel", channels, pos_embed)
    # the last checkpoint served: the sidecar's channels and positions, the
    # channels' embeddings averaged into one (B, S, D)
    rt = hear_natjepa.load_model(str(ckpts[0]), in_channels=channels, device="cpu")
    assert (rt.in_channels, rt.config.pos_embed) == (channels, pos_embed)
    rng = np.random.default_rng(4)
    clips = [0.1 * rng.standard_normal((channels, n)).astype(np.float32) for n in (8000, 5000)]
    emb, ts = hear_natjepa.get_timestamp_embeddings(clips, rt)
    assert emb.ndim == 3 and emb.shape[0] == 2 and emb.shape[-1] == rt.config.encoder_dim
    assert tuple(ts.shape) == tuple(emb.shape[:2]) and torch.isfinite(emb).all()
    scene = hear_natjepa.get_scene_embeddings(clips, rt)
    assert tuple(scene.shape) == (2, rt.config.encoder_dim) and torch.isfinite(scene).all()
