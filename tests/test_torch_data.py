"""The port's host data path against the JAX package's, on shards written to
``tmp_path`` from seeded numpy: shard patterns and striping equal; tar
iteration the same keys and payloads; decoding, preprocessing and int16
quantization equal bit for bit; the streaming shuffle equal batches; the
thread-backed source the same clips for the same seed; the process backend
under ``spawn`` without torch in its workers; and the configured pipeline's
batches of the contract's shape. No module of ``wavjepa_tpu_torch.data``
imports torch."""

import ast
import io
import pathlib
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest
from scipy.io import wavfile

from tests.test_flac import encode_flac, write_verbatim
from wavjepa_tpu.data import decode as jdecode
from wavjepa_tpu.data import pipeline as jpipe
from wavjepa_tpu.data import shards as jshards
from wavjepa_tpu_torch.data import decode, pipeline, shards
from wavjepa_tpu_torch.data._native import build as native_build
from wavjepa_tpu_torch.train.config import Config, apply_overrides

DATA_DIR = pathlib.Path(pipeline.__file__).parent


def wav_bytes(x: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, x)
    return buf.getvalue()


def npy_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def write_shard(path, samples) -> str:
    """A WebDataset tar: each sample a dict of extension → payload, written
    under keys sample0000, sample0001, ..."""
    with tarfile.open(path, "w") as tar:
        for i, sample in enumerate(samples):
            for ext, data in sample.items():
                info = tarfile.TarInfo(name=f"sample{i:04d}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    return str(path)


def audio_samples(rng, n, sr_pairs, seconds):
    """n samples, cycling through (rate, channels): PCM16 WAV, with a json
    member beside each as real shards have."""
    out = []
    for i in range(n):
        sr, ch = sr_pairs[i % len(sr_pairs)]
        x = (rng.standard_normal((int(sr * seconds), ch)) * 3000).astype(np.int16)
        out.append({"wav": wav_bytes(x[:, 0] if ch == 1 else x, sr),
                    "json": b'{"label": %d}' % i})
    return out


def write_audio_shards(tmp_path, n_shards, per_shard, sr_pairs, seconds, seed=0):
    rng = np.random.default_rng(seed)
    paths = [write_shard(tmp_path / f"shard-{s:04d}.tar",
                         audio_samples(rng, per_shard, sr_pairs, seconds))
             for s in range(n_shards)]
    return paths, str(tmp_path / f"shard-{{0000..{n_shards - 1:04d}}}.tar")


def _take(iterable, n):
    it = iter(iterable)
    return [next(it) for _ in range(n)]


def _sorted_bytes(clips):
    return sorted(c.tobytes() for c in clips)


@pytest.mark.parametrize("pattern", [
    "shard-{000008..000011}.tar", "plain.tar", "a-{0..3}.tar, b-{08..10}.tar",
    "/data/as/train-{000000..000019}.tar,/data/ls/{00..02}.tar",
])
def test_patterns_and_striping_match_the_jax_package(pattern):
    expanded = shards.expand_shard_pattern(pattern)
    assert expanded == jshards.expand_shard_pattern(pattern)
    for num_hosts in (1, 2, 3):
        for num_workers in (1, 4):
            seen = []
            for host in range(num_hosts):
                for worker in range(num_workers):
                    part = shards.split_shards(expanded, host, num_hosts, worker, num_workers)
                    assert part == jshards.split_shards(expanded, host, num_hosts, worker,
                                                        num_workers)
                    seen.extend(part)
            assert sorted(seen) == sorted(expanded)  # a partition


def test_mixed_sources_are_assigned_as_in_the_jax_package(tmp_path):
    """Each source striped over its own workers (tests/test_data.py:114):
    every shard of every source read by exactly one worker, with the same
    shards and seeds as the JAX package's."""
    pats = []
    for s in range(2):
        for i in range(8):
            (tmp_path / f"src{s}-{i:04d}.tar").write_bytes(b"")
        pats.append(str(tmp_path / f"src{s}-{{0000..0007}}.tar"))
    for weights, workers in (([0.5, 0.5], 8), ([0.75, 0.25], 4), (None, 3)):
        port = pipeline.ShardAudioSource(pats, mixing_weights=weights, num_workers=workers,
                                         backend="thread", seed=7)
        ref = jpipe.ShardAudioSource(pats, mixing_weights=weights, num_workers=workers,
                                     backend="thread", seed=7)
        assert port.worker_shards == [t._args[0] for t in ref._threads]
        assert [w._args[3] for w in port._workers] == [t._args[3] for t in ref._threads]
        read = [sh for part in port.worker_shards for sh in part]
        assert sorted(read) == sorted(set(read)) == sorted(
            str(tmp_path / f"src{s}-{i:04d}.tar") for s in range(2) for i in range(8))


def test_tar_iteration_matches_the_jax_package(tmp_path, capsys):
    rng = np.random.default_rng(0)
    flac = encode_flac([[lambda w: write_verbatim(w, np.arange(-128, 128), 16)]])
    first = write_shard(tmp_path / "a.tar", [
        {"wav": wav_bytes(rng.standard_normal(400).astype(np.float32), 8000), "json": b"{}"},
        {"npy": npy_bytes(rng.standard_normal((2, 300)).astype(np.float32))},
        {"flac": flac, "cls": b"3"},
    ])
    second = write_shard(tmp_path / "b.tar", audio_samples(rng, 3, [(16000, 1)], 0.05))
    corrupt = tmp_path / "c.tar"
    corrupt.write_bytes(b"this is not a tar archive" * 40)
    for path in (first, second):
        assert list(shards.iter_tar_samples(path)) == list(jshards.iter_tar_samples(path))
    order = [first, str(corrupt), second, str(tmp_path / "missing.tar")]
    got = list(shards.iter_shard_samples(order, repeat=False))
    assert got == list(jshards.iter_shard_samples(order, repeat=False))
    assert [k.rsplit("/", 1)[-1] for k, _ in got] == ["sample0000", "sample0001", "sample0002"] * 2
    assert set(got[2][1]) == {"flac", "cls"}
    assert "skipping corrupt shard" in capsys.readouterr().out
    with pytest.raises((tarfile.TarError, OSError)):
        list(shards.iter_shard_samples([str(corrupt)], repeat=False, handler="raise"))
    # a pass that yields nothing raises instead of spinning for ever
    with pytest.raises(RuntimeError, match="no readable sample"):
        next(shards.iter_shard_samples([str(corrupt)], repeat=True))


def _payloads():
    rng = np.random.default_rng(3)
    n = 1000
    return {
        "wav_pcm16_mono": {"wav": wav_bytes((rng.standard_normal(n) * 8000).astype(np.int16), 16000)},
        "wav_pcm16_stereo": {"wav": wav_bytes((rng.standard_normal((n, 2)) * 8000).astype(np.int16),
                                              44100)},
        "wav_pcm32": {"wav": wav_bytes((rng.standard_normal(n) * 2e8).astype(np.int32), 48000)},
        "wav_pcm8": {"wav": wav_bytes(rng.integers(0, 255, n).astype(np.uint8), 8000)},
        "wav_float32": {"wav": wav_bytes((rng.standard_normal((n, 2)) * 0.3).astype(np.float32),
                                         22050)},
        "npy_1d": {"npy": npy_bytes(rng.standard_normal(n))},
        "npy_2d": {"npy": npy_bytes(rng.standard_normal((3, n)).astype(np.float32))},
        "suffixed_key": {"audio.wav": wav_bytes(np.zeros(10, np.int16), 16000), "json": b"{}"},
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_decode_audio_is_the_jax_packages_bit_for_bit(name):
    sample = _payloads()[name]
    got, sr = decode.decode_audio(sample)
    want, want_sr = jdecode.decode_audio(sample)
    assert sr == want_sr and got.dtype == want.dtype == np.float32 and got.ndim == 2
    np.testing.assert_array_equal(got, want)


def test_decode_audio_errors_match():
    for sample, match in (({"mp3": b"..."}, "mp3 payloads"), ({"json": b"{}"}, "no decodable")):
        with pytest.raises(ValueError, match=match):
            decode.decode_audio(sample)
        with pytest.raises(ValueError, match=match):
            jdecode.decode_audio(sample)


@pytest.mark.parametrize("case", ["short", "long", "silent", "stereo", "loud"])
def test_preprocess_and_quantize_are_the_jax_packages_bit_for_bit(case):
    rng = np.random.default_rng(len(case))
    wav = {
        "short": rng.standard_normal((1, 700)).astype(np.float32) * 0.1,
        "long": rng.standard_normal((1, 2500)).astype(np.float32),
        "silent": np.zeros((1, 900), np.float32),
        "stereo": rng.standard_normal((2, 1600)).astype(np.float32) * 0.5,
        "loud": np.clip(rng.standard_normal((1, 1600)) * 4, -1, 1).astype(np.float32),
    }[case]
    clip = pipeline.preprocess_clip(wav, 1600, 1.0)
    want = jpipe.preprocess_clip(wav, 1600, 1.0)
    assert clip.shape == (wav.shape[0], 1600) and clip.dtype == np.float32
    np.testing.assert_array_equal(clip, want)
    q = pipeline.quantize_clip_int16(clip)
    assert q.dtype == np.int16
    np.testing.assert_array_equal(q, jpipe.quantize_clip_int16(want))


def test_shuffled_batches_are_the_jax_packages():
    stream = [np.full((1, 4), i, np.int16) for i in range(60)]
    got = _take(pipeline.shuffled_batches(iter(stream), 3, shuffle_buffer=7, seed=5), 12)
    want = _take(jpipe.shuffled_batches(iter(stream), 3, shuffle_buffer=7, seed=5), 12)
    assert all(g.shape == (3, 1, 4) for g in got)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    # a stream that ends ends the batches
    assert len(list(pipeline.shuffled_batches(iter(stream[:10]), 3, shuffle_buffer=4))) == 2


# 44.1k stereo (mono-ized, then 44.1k → 1.6k), 3.2k mono (resampled), 1.6k
# mono (as it is), for 1-s clips at 1.6 kHz
SMALL_RATES = [(44100, 2), (3200, 1), (1600, 1)]


def test_thread_source_gives_the_jax_packages_clips(tmp_path):
    """One worker: the same clips in the same order, for more than one pass
    over the shards (the seeded shard order, the repeat). Three workers
    over two sources: thread order is free, so the distinct clips seen."""
    _, pattern = write_audio_shards(tmp_path, 3, 2, SMALL_RATES, 0.7)
    kw = dict(target_sr=1600, target_seconds=1.0, seed=11, backend="thread",
              transfer_dtype="int16", queue_size=4)
    with pipeline.ShardAudioSource(pattern, num_workers=1, **kw) as port:
        got = _take(port, 9)
    ref = jpipe.ShardAudioSource(pattern, num_workers=1, **kw).start()
    try:
        want = _take(ref, 9)
    finally:
        ref.stop()
    assert all(c.shape == (1, 1600) and c.dtype == np.int16 for c in got)
    assert len({c.tobytes() for c in got}) == 6  # 6 samples, then the second pass
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    other = tmp_path / "other"
    other.mkdir()
    _, pattern2 = write_audio_shards(other, 2, 2, SMALL_RATES, 0.4, seed=1)
    kw.update(mixing_weights=[2.0, 1.0], num_workers=3)
    with pipeline.ShardAudioSource([pattern, pattern2], **kw) as port:
        got = _take(port, 40)
    ref = jpipe.ShardAudioSource([pattern, pattern2], **kw).start()
    try:
        want = _take(ref, 40)
    finally:
        ref.stop()
    assert set(_sorted_bytes(got)) == set(_sorted_bytes(want))
    assert len(set(_sorted_bytes(got))) == 10
    assert port.alive() == 0


def test_process_backend_spawns_workers_without_torch(tmp_path):
    """Two worker processes over two shards under ``spawn``: each clip is one
    the JAX package's functions make from a sample of the shards; the
    workers are joined on stop. A fresh interpreter that imports every data
    module (what each spawned worker does) has not loaded torch."""
    paths, pattern = write_audio_shards(tmp_path, 2, 2, SMALL_RATES, 0.5)
    expected = set()
    for path in paths:
        for _, sample in jshards.iter_tar_samples(path):
            wav, sr = jdecode.decode_audio(sample)
            wav = jpipe.resample_np(wav[:1], sr, 1600) if sr != 1600 else wav[:1]
            expected.add(jpipe.quantize_clip_int16(jpipe.preprocess_clip(wav, 1600, 1.0)).tobytes())
    source = pipeline.ShardAudioSource(pattern, target_sr=1600, target_seconds=1.0,
                                       num_workers=2, seed=3, transfer_dtype="int16")
    assert source.worker_shards == [[paths[0]], [paths[1]]]
    with source:
        got = _take(source, 8)
        assert source.alive() == 2
    assert {c.tobytes() for c in got} <= expected
    assert len({c.tobytes() for c in got}) >= 2
    assert source.alive() == 0

    # 128 clips larger than a pipe's buffer, left queued: stop() reads them
    # out while the workers flush, so each worker exits on its own (exit code
    # 0) inside a 5-s limit, not terminated at it
    big = pipeline.ShardAudioSource(pattern, target_sr=1600, target_seconds=40.0,
                                    num_workers=2, queue_size=128)
    big.start()
    _take(big, 2)
    deadline = time.monotonic() + 10.0
    while big.queue.qsize() < 120 and time.monotonic() < deadline:
        time.sleep(0.1)
    big.stop(timeout=5.0)
    assert [w.exitcode for w in big._workers] == [0, 0]

    modules = sorted("wavjepa_tpu_torch." + ".".join(p.relative_to(DATA_DIR.parent).with_suffix("").parts)
                     for p in DATA_DIR.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=DATA_DIR.parents[1]).stdout
    assert out.strip() == "[]"


def test_data_modules_import_no_torch():
    for path in sorted(DATA_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("torch", "jax", "wavjepa_tpu"), (path, name)


def test_a_failed_worker_raises_in_the_consumer(tmp_path):
    missing = str(tmp_path / "nothing-{00..01}.tar")
    source = pipeline.ShardAudioSource(missing, num_workers=1, backend="thread").start()
    try:
        with pytest.raises(RuntimeError, match="no readable sample"):
            next(iter(source))
    finally:
        source.stop()
    assert source.alive() == 0


def test_configured_pipeline_gives_int16_batches_of_the_contract(tmp_path):
    """``audio_shard_batches`` from the port's Config: (B, 1, 160000) int16
    at the defaults' 16 kHz and 10 s, from 22.05k and 16k mono and 44.1k
    stereo clips of 2 s (padded to 10 s)."""
    _, pattern = write_audio_shards(tmp_path, 2, 2, [(22050, 1), (16000, 1), (44100, 2)], 2.0)
    cfg = apply_overrides(Config(), [f"data.data_dirs={pattern}", "data.num_workers=0",
                                     "data.shuffle_buffer=3", "trainer.batch_size=2"])
    assert cfg.data.transfer_dtype == "int16"
    batches = pipeline.audio_shard_batches(cfg)
    try:
        first, second = _take(batches, 2)
    finally:
        batches.stop()
    for b in (first, second):
        assert b.shape == (2, 1, 160000) and b.dtype == np.int16
        assert np.abs(b[:, :, :32000]).max() == 32767  # peak-normalized
        assert not b[:, :, 44100:].any()  # 2 s of audio, then zeros (at most 2.0 s)
    assert batches.source.alive() == 0


def test_native_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native_build, "SOURCES", (bad,))
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="native build failed") as err:
        native_build.build()
    assert "bad.cc" in str(err.value) and "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*.so"))
