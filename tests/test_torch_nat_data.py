"""The scene data path in the port against the JAX package's, on shards
written to ``tmp_path`` from seeded numpy (clean WAV clips, .npy tars of
2-channel RIR stacks and of noise): ``DenoiseSampleSource`` loading on one
thread a stream gives the JAX package's samples, banks and bank refreshes
for the same seed; the synthetic scene batches are the JAX package's; the
side channel's ``spawn`` workers stop; and ``train_jepa`` trains the Nat
configuration from shards with the device banks on the CPU at tiny size."""

import numpy as np
import pytest
import torch

from tests.test_torch_data import npy_bytes, wav_bytes, write_shard
from wavjepa_tpu.data import denoise_pipeline as jdp
from wavjepa_tpu.train import denoise_loop as jdl
from wavjepa_tpu_torch.data import denoise_pipeline as tdp
from wavjepa_tpu_torch.train import denoise_loop as tdl
from wavjepa_tpu_torch.train.config import Config, apply_overrides
from wavjepa_tpu_torch.train.loop import build_data_iterator, train_jepa

SR = 3200  # the scene rate of these tests


def write_scene_shards(root, sr=SR, clip_s=0.5, seed=0):
    """(audio, rir, noise) patterns: 2 WAV shards of 3 clips of varied
    length, 2 .npy shards of 3 stacks of (1 + 0..2) 2-channel RIRs of
    varied length, 1 .npy shard of 4 noise rows shorter and longer than a
    1-s clip."""
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    for s in range(2):
        write_shard(root / f"audio-{s}.tar", [
            {"wav": wav_bytes((rng.standard_normal(int(sr * clip_s * (1 + i)))
                               * 3000).astype(np.int16), sr)} for i in range(3)])
        write_shard(root / f"rir-{s}.tar", [
            {"npy": npy_bytes(rng.standard_normal((1 + i, 2, 300 + 400 * i))
                              .astype(np.float32))} for i in range(3)])
    write_shard(root / "noise-0.tar", [
        {"npy": npy_bytes(rng.standard_normal(int(sr * f)).astype(np.float32))}
        for f in (0.4, 1.7, 0.9, 2.5)])
    return (str(root / "audio-{0..1}.tar"), str(root / "rir-{0..1}.tar"),
            str(root / "noise-0.tar"))


class _OneWorkerNpySource(jdp.NpySideSource):
    """The JAX package's side channel on one worker: with several threads
    its order would be the threads' race."""

    def __init__(self, pattern, num_workers=1, **kw):
        super().__init__(pattern, num_workers=1, **kw)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("banks", [(0, 0, "float32"), (4, 3, "int16")])
def test_sample_source_gives_the_jax_packages_samples(tmp_path, monkeypatch, banks):
    rir_bank, noise_bank, wire = banks
    audio, rir, noise = write_scene_shards(tmp_path)
    kw = dict(rir_pattern=rir, noise_pattern=noise, sr=SR, target_seconds=1.0, seed=5,
              transfer_dtype=wire, rir_bank_size=rir_bank, noise_bank_size=noise_bank,
              max_noise_sources=3, rir_seconds=0.25)
    monkeypatch.setattr(jdp, "NpySideSource", _OneWorkerNpySource)
    ref = jdp.DenoiseSampleSource(audio, num_workers=0, backend="thread", **kw)
    port = tdp.DenoiseSampleSource(audio, num_workers=0, **kw)
    try:
        _assert_same(port.scene_bank() or {}, ref.scene_bank() or {})
        got = tdp.denoise_batches(port, 3, refresh_rirs_per_batch=2)
        want = jdp.denoise_batches(ref, 3, refresh_rirs_per_batch=2)
        for _ in range(3):
            g, w = next(got), next(want)
            _assert_same(g, w)
        assert g["audio"].shape == (3, SR) and g["snr"].shape == (3,)
        if rir_bank:
            assert "rir_bank_refresh" in g and g["rir_index"].dtype == np.int32
            assert g["rir_bank_refresh"]["rows"]["source_rir"].shape == (2, 2, 800)
        else:
            assert g["source_rir"].shape == (3, 2, 800)
            assert g["noise_rirs"].shape == (3, 3, 2, 800)
    finally:
        ref.stop()
        port.stop()
    assert not any(w.is_alive() for s in (port.audio, port.rirs, port.noise)
                   for w in s._workers)


def test_synthetic_scene_batches_are_the_jax_packages():
    kw = dict(scene_len=500, rir_len=300, max_noise=3, n_channels=2, seed=4)
    for g, w in zip(tdl.synthetic_denoise_batches(2, **kw), jdl.synthetic_denoise_batches(2, **kw)):
        _assert_same(g, w)
        break
    g = next(tdl.synthetic_denoise_batches(2, with_rir=False, **kw))
    assert set(g) == {"audio", "noise", "noise_start", "noise_length", "snr"}


def test_scene_flags_follow_what_the_batches_carry():
    nat = ["data.nat_scenes=true", "data.in_channels=2"]
    assert tdl.effective_scene_flags(apply_overrides(Config(), nat)) == (True, True)
    shards = apply_overrides(Config(), [*nat, "data.data_dirs=a.tar", "data.rir_dir=r.tar"])
    assert tdl.effective_scene_flags(shards) == (True, False)
    batches = build_data_iterator(apply_overrides(Config(), [
        *nat, "data.synthetic=true", "data.target_seconds=0.1", "trainer.batch_size=2"]))
    batch = next(batches)
    assert batch["audio"].shape == (2, 3200) and batch["source_rir"].shape == (2, 2, 64000)
    assert batch["noise_rirs"].shape == (2, 5, 2, 64000)


def test_side_channel_processes_stop(tmp_path):
    _, rir, _ = write_scene_shards(tmp_path)
    source = tdp.NpySideSource(rir, num_workers=2, shuffle_buffer=2, queue_size=4).start()
    try:
        arrays = [next(source) for _ in range(5)]
    finally:
        source.stop(timeout=5.0)
    assert all(a.ndim == 3 and a.shape[1] == 2 for a in arrays)
    assert [w.exitcode for w in source._workers] == [0, 0]


def test_a_failed_side_channel_raises_in_the_consumer(tmp_path):
    source = tdp.NpySideSource(str(tmp_path / "none-{0..1}.tar"), backend="thread").start()
    try:
        with pytest.raises(RuntimeError, match="no readable sample"):
            next(source)
    finally:
        source.stop()


def test_nat_trains_from_shards_with_device_banks_on_the_cpu(tmp_path):
    audio, rir, noise = write_scene_shards(tmp_path / "shards", sr=32000, clip_s=0.2)
    cfg = apply_overrides(Config(), [
        "data.nat_scenes=true", "data.in_channels=2", "extractor.channel_wise=true",
        "extractor.pos_embed=binaural", "masker.channel_based_masking=true",
        "trainer.size=tiny", "trainer.batch_size=2", "data.samples_per_audio=2",
        "data.process_seconds=0.201", "data.target_seconds=0.4", "trainer.log_every=1",
        f"data.data_dirs={audio}", f"data.rir_dir={rir}", f"data.noise_dir={noise}",
        "data.num_workers=0", "data.rir_bank_size=3", "data.noise_bank_size=2",
        "data.rir_refresh_per_batch=1", f"trainer.save_dir={tmp_path / 'run'}"])
    batches = build_data_iterator(cfg)
    bank = batches.source.scene_bank()
    assert bank["source_rir"].shape == (3, 2, 64000) and bank["noise"].dtype == np.int16
    batches.stop()
    state = train_jepa(cfg, max_steps=3, device="cpu")
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
