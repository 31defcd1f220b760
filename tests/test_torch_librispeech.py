"""The LibriSpeech pretraining recipe (``configs/librispeech.yaml``: the
wav2vec2 frontend, the speech masker, no packing) in the port, against the
JAX package, and the FLAC shards both recipes read.

* Config resolution: the file and its ``data.process_seconds=4.02`` form
  resolve alike in both packages (frontend, tokens, crop length, packing
  off, recomputation, accumulation, masker) and to the JAX package's step
  FLOPs (78.48 and 160.75 TFLOP), exactly.
* Step parity: two port steps against two JAX steps (``jepa_loss_fn``,
  clip + AdamW, EMA, as tests/test_torch_train_step.py drives them) on
  speech masks from the JAX masker, through a narrow frontend of
  wav2vec2's pattern (kernel 10 stride 5, then 3/2, then 2/2; GroupNorm on
  layer 0), unpacked, the frontend and the encoder replayed as the recipe
  resolves them; at that file's tolerances (loss rtol 1e-5, gradient norm
  rtol 1e-4, weights and teacher atol 2e-6 rtol 1e-4). Two microbatches
  equal one pass at its accumulation test's (loss rtol 1e-5, weights rtol
  2e-4 atol 2e-5).
* The speech masker's visible-ratio and target-count distributions against
  the JAX masker and the reference's rejection loop (numpy) at T = 100
  and 200, at tests/test_torch_masking.py's thresholds.
* The port's FLAC writer (``data/synthetic.encode_flac``): every payload
  decodes bit for bit through the port's decoder and the JAX package's,
  and its streams, read back field by field, hold what ``flac -5``
  writes.
* A LibriSpeech-layout and an AudioSet-layout FLAC shard through both
  packages' ``ShardAudioSource`` (thread backend): the same 10-s clips,
  bit for bit.
* The recipe's CLI on a tiny model from FLAC shards on the CPU, and its
  checkpoint served by ``load_model`` from the sidecar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavjepa_tpu.api.convert import convert_jepa_state_dict as jax_convert_state_dict
from wavjepa_tpu.data import pipeline as jpipe
from wavjepa_tpu.data._native import flac_native as jax_flac
from wavjepa_tpu.masking import SpeechMaskConfig as JaxSpeechConfig
from wavjepa_tpu.masking import speech_masks as jax_speech_masks
from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
from wavjepa_tpu.ops.audio import instance_normalize as jax_instance_normalize
from wavjepa_tpu.train import config as jcfg
from wavjepa_tpu.train.schedule import ema_decay_schedule as jax_ema_schedule
from wavjepa_tpu.train.state import TrainState as JaxTrainState
from wavjepa_tpu.train.state import ema_update as jax_ema_update
from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from wavjepa_tpu.train.step import jepa_loss_fn as jax_jepa_loss_fn
from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
from wavjepa_tpu.utils import flops as jflops
from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
from wavjepa_tpu_torch.data import flac, pipeline, synthetic
from wavjepa_tpu_torch.masking import SpeechMaskConfig, sample_span_mask_np, speech_masks
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops.conv_frontend import WAV2VEC2_CONV_SPEC
from wavjepa_tpu_torch.train import config as tcfg
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    EMAConfig,
    OptimizerConfig,
    make_jepa_train_step,
    make_optimizer,
)
from wavjepa_tpu_torch.utils import flops as tflops

RECIPE = "configs/librispeech.yaml"


# ----------------------------------------------------------- config resolution


@pytest.mark.parametrize("seconds,tokens,samples,tflop", [
    (None, 100, 32159, 78.475362828288), ("4.02", 200, 64319, 160.746568679424)])
def test_the_recipe_resolves_as_the_jax_package(seconds, tokens, samples, tflop):
    extra = [] if seconds is None else [f"data.process_seconds={seconds}"]
    port = tcfg.apply_overrides(tcfg.load_config(RECIPE), list(extra))
    ref = jcfg.apply_overrides(jcfg.load_config(RECIPE), list(extra))
    pm, jm = port.build_model_config(), ref.build_model_config()
    assert pm.conv_spec == jm.conv_spec == WAV2VEC2_CONV_SPEC
    assert pm.extractor_mode == jm.extractor_mode == "default"
    assert (pm.total_patches, pm.target_length) == (jm.total_patches, jm.target_length) == (
        tokens, samples)
    assert (pm.pack_encoder, pm.pack_decoder) == (jm.pack_encoder, jm.pack_decoder) == (
        None, None)
    assert port.packing_bounds(pm.total_patches) == (None, None)
    # with packing off, the frontend and the encoder follow trainer.remat;
    # at accum 16 the predictor is not replayed
    flags = ("remat", "remat_conv", "remat_encoder", "remat_decoder", "remat_save_probs")
    assert [getattr(pm, f) for f in flags] == [getattr(jm, f) for f in flags] == [
        True, None, None, False, False]
    assert port.resolved_accum_steps() == ref.resolved_accum_steps() == 16
    (fn, mcfg), (_, jmcfg) = port.masker.build(), ref.masker.build()
    assert fn is speech_masks
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(jmcfg)
    assert mcfg == SpeechMaskConfig()  # configs/masker/LibriSpeech.yaml's
    crops = port.trainer.batch_size * port.data.samples_per_audio
    assert crops == 512
    assert tflops.jepa_step_flops(pm, crops) == jflops.jepa_step_flops(jm, crops)
    assert tflops.jepa_step_flops(pm, crops) / 1e12 == pytest.approx(tflop, rel=1e-12)


# ---------------------------------------------------------------- step parity

# a narrow frontend of wav2vec2's pattern at 1.6 kHz: 801 samples → 39 tokens
TINY = dict(
    conv_spec=((32, 10, 5), (32, 3, 2), (32, 2, 2)), extractor_mode="default",
    encoder_layers=2, encoder_dim=32, encoder_heads=4, decoder_layers=2, decoder_dim=16,
    decoder_heads=4, sample_rate=1600, process_seconds=0.501, average_top_k_layers=2,
    remat=True, remat_decoder=False,  # as the recipe resolves at accum 16
)
MASK = dict(target_masks_per_context=2, target_prob=0.2, target_length=4, min_context_len=2,
            ratio_cutoff=0.5)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
EMA_END = 50


def _inputs(seed, n_rows, jc):
    rng = np.random.default_rng(seed)
    crops = rng.standard_normal((n_rows, 1, jc.target_length)).astype(np.float32) * 2 + 0.5
    crops = np.array(jax_instance_normalize(jnp.asarray(crops)))
    masks = jax_speech_masks(jax.random.PRNGKey(seed), batch_size=n_rows,
                             n_times=jc.total_patches, cfg=JaxSpeechConfig(**MASK))
    return (crops, *(np.array(m) for m in masks))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's weights and its two steps on two batches of 4 crops."""
    jc = JaxConfig(**TINY)
    assert jc.total_patches == 39
    model = JaxJEPA(jc)
    # seeded port weights in the JAX tree (flax's init of even this model
    # takes seconds), by the JAX package's own converter
    seeded = JEPA(JEPAConfig(**TINY))
    seeded.init_parameters(torch.Generator().manual_seed(0))
    params, _ = jax_convert_state_dict(
        {k: v.detach().numpy() for k, v in seeded.state_dict().items()},
        encoder_layers=jc.encoder_layers, decoder_layers=jc.decoder_layers,
        conv_layers=len(jc.conv_spec), mode=jc.extractor_mode)
    batches = [_inputs(10 + i, 4, jc) for i in range(2)]
    tx, sched = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    ema = jax_ema_schedule(anneal_end_step=EMA_END)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t, *xs: jax_jepa_loss_fn(model, p, t, *xs)))
    update = jax.jit(tx.update)  # eager, the update alone takes seconds
    state = JaxTrainState.create(params, tx)
    p, teacher, opt_state, out = state.params, state.teacher_encoder, state.opt_state, []
    for step, batch in enumerate(batches):
        loss, grads = grad_fn(p, teacher, *map(jnp.asarray, batch))
        updates, opt_state = update(grads, opt_state, p)
        teacher = jax_ema_update(teacher, p["encoder"], ema(step))
        p = optax.apply_updates(p, updates)
        out.append((float(loss), float(optax.global_norm(grads)), float(sched(step))))
    return params, batches, p, teacher, out


def _port_run(params, batches, accum):
    model = JEPA(JEPAConfig(**TINY))
    model.load_state_dict(state_dict_from_jax_params(params))
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**OPT), model))
    step = make_jepa_train_step(OptimizerConfig(**OPT), nr_samples_per_audio=2,
                                masker_cfg=SpeechMaskConfig(**MASK),
                                ema_cfg=EMAConfig(anneal_end_step=EMA_END), accum_steps=accum)
    metrics = []
    for batch in batches:
        state, m = step.step_on(state, *map(torch.from_numpy, batch))
        metrics.append(m)
    return state, metrics


def test_two_speech_masked_steps_match_jax(jax_side):
    params, batches, ref_params, ref_teacher, ref = jax_side
    # the masks are the speech masker's: mostly visible context, unpacked
    ctx = batches[0][1]
    assert 0.5 <= (~ctx).mean() < 1.0
    # the frontend and the encoder replayed
    assert JEPA.remat_flags(JEPAConfig(**TINY))[:2] == (True, True)
    state, metrics = _port_run(params, batches, accum=1)
    for m, (loss, g_norm, lr) in zip(metrics, ref):
        np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), g_norm, rtol=1e-4)
        np.testing.assert_allclose(m["lr"], lr, rtol=1e-6)
    assert state.step == 2 and ref[1][2] > 0
    ref_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, ref_params),
                                        teacher_encoder=jax.tree.map(np.asarray, ref_teacher))
    assert any(k.startswith("extract_audio.cnn.0.2.") for k in ref_sd)  # layer 0's GroupNorm
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=2e-6, rtol=1e-4, err_msg=k)
    for k, v in state.teacher_encoder.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[f"teacher_encoder.{k}"].numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=k)


def test_two_microbatches_equal_one_pass(jax_side):
    params, batches, *_ = jax_side
    (one, m1), (two, m2) = (_port_run(params, batches, accum) for accum in (1, 2))
    np.testing.assert_allclose(m2[-1]["loss"].item(), m1[-1]["loss"].item(), rtol=1e-5)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(two.model.state_dict()[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


# ------------------------------------------------------------- masker


def _filter_small_runs_np(mask, min_len):
    out = mask.copy()
    padded = np.concatenate([[False], mask, [False]])
    starts = np.flatnonzero(~padded[:-1] & padded[1:])
    ends = np.flatnonzero(padded[:-1] & ~padded[1:])
    for s, e in zip(starts, ends):
        if e - s < min_len:
            out[s:e] = False
    return out


def _speech_reference_np(rng, batch, t, cfg):
    """The reference's SpeechMasker in numpy: targets only, the context
    their complement less runs shorter than min_context_len, resampled until
    the visible ratio reaches the cutoff."""
    ctx_rows, tgt_rows = [], []
    for _ in range(batch):
        while True:
            targets = np.stack([sample_span_mask_np(rng, t, cfg.target_prob, cfg.target_length)
                                for _ in range(cfg.target_masks_per_context)])
            ctx_visible = _filter_small_runs_np(~targets.any(0), cfg.min_context_len)
            if ctx_visible.mean() >= cfg.ratio_cutoff:
                break
        ctx_rows.append(~ctx_visible)
        tgt_rows.append(targets)
    return np.stack(ctx_rows), np.stack(tgt_rows)


def _ks(a, b):
    grid = np.unique(np.concatenate([a, b]))
    ca = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    cb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return np.abs(ca - cb).max()


@pytest.mark.parametrize("t", [100, 200])
def test_speech_masker_distribution_matches_jax_and_the_reference(t):
    cfg = SpeechMaskConfig()
    ctx_p, tgt_p, _ = (m.numpy() for m in speech_masks(torch.Generator().manual_seed(t), 2048,
                                                        t, cfg=cfg))
    ctx_j, tgt_j, _ = (np.asarray(m) for m in jax_speech_masks(
        jax.random.PRNGKey(t), batch_size=2048, n_times=t, cfg=JaxSpeechConfig()))
    ctx_r, tgt_r = _speech_reference_np(np.random.default_rng(t), 800, t, cfg)
    vr_p, vr_j, vr_r = ((~c).mean(axis=-1) for c in (ctx_p, ctx_j, ctx_r))
    assert vr_p.mean() > 0.5  # most tokens visible, as the recipe's cutoff makes them
    for other in (vr_j, vr_r):
        assert abs(vr_p.mean() - other.mean()) < 0.02
        assert abs(vr_p.std() - other.std()) < 0.3 * other.std()
        assert _ks(vr_p, other) < 0.12
    tc_p, tc_j, tc_r = (g.sum(axis=-1).ravel().astype(float) for g in (tgt_p, tgt_j, tgt_r))
    for other in (tc_j, tc_r):
        assert abs(tc_p.mean() - other.mean()) < 0.05 * other.mean()
        assert _ks(tc_p, other) < 0.12
    assert not (tgt_p & ~ctx_p[:, None, :]).any()


# ------------------------------------------------------------- FLAC writer


def _payloads():
    rng = np.random.default_rng(3)
    speech = synthetic.speech_like_audio(rng, 1.5, 16000)[0].astype(np.int64)
    # speech, a whole block of digital silence, a block of full-scale noise,
    # and a short last block
    mixed = np.concatenate([speech, np.zeros(8192, np.int64),
                            rng.integers(-32768, 32768, 8192), speech[:5000]])
    walk = np.clip(np.cumsum(rng.integers(-40, 41, 9000)), -32768, 32767)
    out = {"mono_mixed": (mixed, 16000), "mono_walk": (walk, 22050),
           "speech_auto": (synthetic.speech_like_audio(rng, 2.2, 44100, 2), 44100)}
    # pairs of channels for which each stereo assignment is the smallest:
    # a voice over a quiet other one, one channel twice the other (either
    # way), and a voice with ±noise on each side
    x = synthetic.speech_like_audio(rng, 1.2, 48000)[0].astype(np.int64) // 3
    y = synthetic.speech_like_audio(rng, 1.2, 48000)[0].astype(np.int64) // 10
    noise = np.round(rng.standard_normal(x.size) * 300).astype(np.int64)
    for mode, pair in (("independent", (x, y)), ("left_side", (x, 2 * x)),
                       ("right_side", (2 * x, x)), ("mid_side", (x + noise, x - noise))):
        out[f"stereo_{mode}"] = (np.stack(pair), 48000)
    return out


PAYLOADS = _payloads()
_SIDE_CHANNEL = {8: 1, 9: 0, 10: 1}  # channel assignment → its side subframe


def _read_flac(data: bytes) -> list:
    """The frames of a FLAC stream as written, read back field by field
    (FLAC's format specification): per frame its block size, channel
    assignment and subframes, each (kind,) or (kind, order, partition order,
    Rice method). The residuals are skipped, not decoded."""
    bits = "".join(f"{b:08b}" for b in data)
    pos = 32
    assert data[:4] == b"fLaC"

    def take(n):
        nonlocal pos
        pos += n
        return int(bits[pos - n:pos], 2)

    last = 0
    while not last:  # metadata blocks
        last, _, length = take(1), take(7), take(24)
        pos += 8 * length
    frames = []
    while pos < len(bits):
        assert take(14) == 0x3FFE and take(2) == 0  # sync, fixed block size
        bs_code, _, assign, _, _ = take(4), take(4), take(4), take(3), take(1)
        lead = take(8)  # the frame number's first byte; its leading ones count the bytes
        pos += 8 * max(0, len(f"{lead:08b}") - len(f"{lead:08b}".lstrip("1")) - 1)
        n = synthetic.BLOCKSIZE if bs_code == 12 else take(8 if bs_code == 6 else 16) + 1
        pos += 8  # CRC-8
        subframes = []
        for ch in range(2 if assign >= 8 else assign + 1):
            bps = 16 + (_SIDE_CHANNEL.get(assign) == ch)
            _, kind, wasted = take(1), take(6), take(1)
            assert not wasted
            if kind in (0, 1):
                pos += bps * (n if kind else 1)
                subframes.append(("verbatim" if kind else "constant",))
                continue
            name, order = ("fixed", kind - 8) if kind < 32 else ("lpc", kind - 31)
            pos += order * bps  # warm-up samples
            if name == "lpc":
                precision = take(4) + 1
                pos += 5 + order * precision  # shift, coefficients
            method, part_order = take(2), take(4)
            for part in range(1 << part_order):
                k = take(5 if method else 4)
                for _ in range((n >> part_order) - (order if part == 0 else 0)):
                    pos = bits.index("1", pos) + 1 + k  # unary quotient, k low bits
            subframes.append((name, order, part_order, method))
        pos += -pos % 8 + 16  # padding to a byte, CRC-16
        frames.append({"n": n, "assign": assign, "subframes": subframes})
    return frames


@pytest.fixture(scope="module")
def encoded():
    return {name: synthetic.encode_flac(x, sr) for name, (x, sr) in PAYLOADS.items()}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_flac_writer_decodes_bit_for_bit_in_both_packages(encoded, name):
    x, sr = PAYLOADS[name]
    want = np.atleast_2d(x).astype(np.float32) / 32768
    for decode in (flac.decode, jax_flac.decode_flac):
        got, rate = decode(encoded[name])
        assert rate == sr and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_flac_writer_writes_what_flac_5_writes(encoded):
    frames = {name: _read_flac(data) for name, data in encoded.items()}
    subs = [sub for fs in frames.values() for f in fs for sub in f["subframes"]]
    assert sum(f["n"] for f in frames["mono_mixed"]) == PAYLOADS["mono_mixed"][0].size
    kinds = {sub[0] for sub in subs}
    assert kinds == {"constant", "verbatim", "fixed", "lpc"}
    lpc_orders = {sub[1] for sub in subs if sub[0] == "lpc"}
    assert 8 in lpc_orders and max(lpc_orders) <= synthetic.MAX_LPC_ORDER
    assert {sub[2] for sub in subs if len(sub) > 1} >= {0, 1, 5}  # partition orders
    assert {sub[3] for sub in subs if len(sub) > 1} == {0, 1}  # Rice parameter methods
    # each pair of channels takes the assignment it was made for, every frame
    for mode, code in synthetic.STEREO_MODES.items():
        assert {f["assign"] for f in frames[f"stereo_{mode}"]} == {code}
    for fs in frames.values():  # 4096-sample blocks and a short last one
        assert {f["n"] for f in fs[:-1]} == {synthetic.BLOCKSIZE}
        assert 0 < fs[-1]["n"] < synthetic.BLOCKSIZE
    # the speech compresses (LPC does real work) and the CRCs are FLAC's
    x, _ = PAYLOADS["speech_auto"]
    assert len(encoded["speech_auto"]) < 0.8 * x.nbytes
    assert synthetic.crc8(b"123456789") == 0xF4
    assert synthetic.crc16(np.frombuffer(b"123456789", np.uint8)) == 0xFEE8


# -------------------------------------------------------------- shards


def _take(source, n):
    it = iter(source)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("layout", ["librispeech", "audioset"])
def test_flac_shards_give_the_jax_packages_clips(tmp_path, layout):
    if layout == "librispeech":
        pattern, written = synthetic.write_librispeech_shards(str(tmp_path), 1, 3)
        keys = sorted(written)
        assert keys == [keys[0].rsplit("-", 1)[0] + f"-{u:04d}" for u in range(3)]
        lengths = sorted(v.shape[1] for v in written.values())
        assert lengths[0] < 160000 < lengths[-1]  # one shorter than 10 s, one longer
    else:
        pattern, written = synthetic.write_audioset_shards(str(tmp_path), 1, 2, seconds=3.0)
        assert all(v.shape == (2, 132300) for v in written.values())
    kw = dict(target_sr=16000, target_seconds=10.0, seed=4, backend="thread",
              transfer_dtype="int16", queue_size=4, num_workers=1)
    with pipeline.ShardAudioSource(pattern, **kw) as port:
        got = _take(port, len(written))
    ref = jpipe.ShardAudioSource(pattern, **kw).start()
    try:
        want = _take(ref, len(written))
    finally:
        ref.stop()
    assert all(c.shape == (1, 160000) and c.dtype == np.int16 for c in got)
    assert len({c.tobytes() for c in got}) == len(written)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------- the CLI and serving


def test_the_recipes_cli_trains_from_flac_shards_and_its_checkpoint_serves(tmp_path):
    from wavjepa_tpu_torch.api.runtime import load_model
    from wavjepa_tpu_torch.train.__main__ import main

    pattern, _ = synthetic.write_librispeech_shards(str(tmp_path / "shards"), 2, 2)
    # the recipe on the tiny transformer, its frontend's kernels and strides
    # at 32 channels (100 tokens a 2.01-s crop), 2 clips × 2 crops in 2
    # microbatches, so that the frontend and the encoder are replayed
    narrow = [[32, k, s] for _, k, s in WAV2VEC2_CONV_SPEC]
    save_dir = tmp_path / "runs"
    main([RECIPE, f"data.data_dirs={pattern}", "data.num_workers=0", "data.shuffle_buffer=4",
          "trainer.size=tiny", "trainer.batch_size=2", "data.samples_per_audio=2",
          "trainer.accum_steps=2", "trainer.average_top_k_layers=2", "trainer.steps=2",
          "trainer.log_every=1", "optimizer.warmup_steps=1", f"trainer.save_dir={save_dir}",
          f"extractor.conv_spec={narrow}".replace(" ", ""), "--device", "cpu"])
    (ckpt,) = save_dir.rglob("step_00000002.ckpt")
    assert "Extractor=wav2vec2" in str(ckpt) and "Masking=speech-masker" in str(ckpt)
    rt = load_model(str(ckpt), device="cpu")
    cfg = rt.config
    assert cfg.conv_spec == tuple(tuple(layer) for layer in narrow)
    assert (cfg.extractor_mode, cfg.pos_embed, cfg.total_patches) == ("default", "time", 100)
    assert cfg.pack_encoder is None and cfg.dtype == torch.bfloat16
    clips = [np.random.default_rng(i).standard_normal(n).astype(np.float32)
             for i, n in enumerate((16000 * 3, 16000))]
    emb, ts = rt.get_timestamp_embeddings(clips)
    assert emb.shape[0] == 2 and emb.shape[2] == cfg.encoder_dim and emb.shape[1] > 100
    assert torch.isfinite(emb).all()
