"""The port's crops, per-crop norm and maskers against the JAX package's.

Arithmetic that takes no random numbers (the norm, the wire format, crops
at given offsets, ``filter_small_runs``, channel tiling) is compared
directly on the same numpy inputs, f32 at atol 1e-6 (one pass of reductions
in another order) or exactly. The samplers draw from ``torch.Generator``
and ``jax.random``, which differ, so they are held to each other by
distribution, as ``tests/test_masking.py`` holds the JAX sampler to the
reference's rejection loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.masking import TimeInverseMaskConfig as JaxTimeInverse
from wavjepa_tpu.masking import filter_small_runs as jax_filter_small_runs
from wavjepa_tpu.masking import time_inverse_block_masks as jax_time_inverse
from wavjepa_tpu.masking.maskers import _tile_channels as jax_tile_channels
from wavjepa_tpu.ops.audio import instance_normalize as jax_instance_normalize
from wavjepa_tpu.ops.audio import random_crops as jax_random_crops
from wavjepa_tpu.ops.scenes import wire_to_f32 as jax_wire_to_f32
from wavjepa_tpu_torch.masking import (
    SpeechMaskConfig,
    TimeInverseMaskConfig,
    filter_small_runs,
    format_mask,
    max_spans,
    sample_span_mask_np,
    sample_span_masks,
    speech_masks,
    time_inverse_block_masks,
)
from wavjepa_tpu_torch.masking.maskers import _tile_channels
from wavjepa_tpu_torch.ops.audio import crops_at, instance_normalize, random_crops, wire_to_f32


def test_instance_normalize_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 4, 2, 500)).astype(np.float32) * 3 + 1
    ref = np.asarray(jax_instance_normalize(jnp.asarray(x), axis=(-2, -1)))
    out = instance_normalize(torch.from_numpy(x), dims=(-2, -1)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_wire_format_matches_jax():
    x = np.random.default_rng(1).integers(-32768, 32767, (2, 1, 300), dtype=np.int16)
    np.testing.assert_array_equal(wire_to_f32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_wire_to_f32(jnp.asarray(x))))
    f = np.random.default_rng(2).standard_normal((2, 1, 30)).astype(np.float32)
    np.testing.assert_array_equal(wire_to_f32(torch.from_numpy(f)).numpy(), f)


def test_crops_at_the_starts_jax_draws_match_jax_random_crops():
    audio = np.random.default_rng(3).standard_normal((3, 2, 1000)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_random_crops(key, jnp.asarray(audio), 321, 4))
    # the same offsets random_crops draws from this key
    starts = np.asarray(jax.random.randint(key, (3, 4), 0, 1000 - 321 + 1))
    out = crops_at(torch.from_numpy(audio), torch.from_numpy(starts).long(), 321).numpy()
    assert out.shape == (3, 4, 2, 321)
    np.testing.assert_array_equal(out, ref)


def test_random_crops_are_windows_of_the_clip():
    audio = torch.arange(2 * 1 * 500, dtype=torch.float32).reshape(2, 1, 500)
    crops = random_crops(torch.Generator().manual_seed(0), audio, 100, 3)
    assert crops.shape == (2, 3, 1, 100)
    for b in range(2):
        for s in range(3):
            start = int(crops[b, s, 0, 0]) - 500 * b
            assert 0 <= start <= 400
            torch.testing.assert_close(crops[b, s, 0], audio[b, 0, start:start + 100])


def test_filter_small_runs_equals_jax():
    rng = np.random.default_rng(4)
    for min_len in (1, 3, 5):
        masks = rng.random((40, 57)) < rng.random((40, 1))
        ref = np.stack([np.asarray(jax_filter_small_runs(jnp.asarray(m), min_len))
                        for m in masks])
        np.testing.assert_array_equal(filter_small_runs(torch.from_numpy(masks), min_len).numpy(),
                                      ref)


def test_channel_major_tiling_equals_jax():
    rng = np.random.default_rng(6)
    ctx = rng.random((3, 20)) < 0.5
    tgt = rng.random((3, 4, 20)) < 0.3
    vis = ctx[:, None, :] ^ tgt
    ref = jax_tile_channels(*map(jnp.asarray, (ctx, tgt, vis)), 2)
    out = _tile_channels(*map(torch.from_numpy, (ctx, tgt, vis)), 2)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # and the channel-based masker tiles its own masks the same way
    cfg = TimeInverseMaskConfig(channel_based_masking=True)
    c2, t2, v2 = time_inverse_block_masks(torch.Generator().manual_seed(0), 4, 2 * 200, 2, cfg)
    assert c2.shape == (4, 400) and t2.shape == (4, 4, 400)
    assert torch.equal(c2[:, :200], c2[:, 200:]) and torch.equal(t2[..., :200], t2[..., 200:])


@pytest.mark.parametrize("t,p,length", [(200, 0.65, 10), (200, 0.25, 10), (31, 0.5, 4)])
def test_span_sampler_invariants(t, p, length):
    m = sample_span_masks(torch.Generator().manual_seed(t), (500,), t, p, length)
    assert m.shape == (500, t) and m.dtype == torch.bool
    covered = m.sum(-1).numpy()
    # at most max_spans spans of `length`, so coverage ≤ max_spans·length
    assert covered.max() <= max_spans(t, p, length) * length
    # the mean span count p·T/L + ½ rounded down on average: coverage near p·T
    assert abs(covered.mean() - p * t) < 0.25 * p * t
    # runs are whole spans: every run is at least `length` long
    edges = np.diff(np.pad(m.numpy().astype(int), ((0, 0), (1, 1))), axis=1)
    starts, ends = np.nonzero(edges == 1), np.nonzero(edges == -1)
    assert ((ends[1] - starts[1]) >= length).all()


def test_time_inverse_masker_invariants():
    cfg = TimeInverseMaskConfig()
    ctx, tgt, vis = time_inverse_block_masks(torch.Generator().manual_seed(1), 256, 200, cfg=cfg)
    assert ctx.shape == (256, 200) and tgt.shape == (256, 4, 200)
    assert torch.equal(vis, ctx[:, None, :] ^ tgt)
    assert not (tgt & ~ctx[:, None, :]).any()  # targets are never context
    assert ((~ctx).float().mean(-1) >= cfg.ratio_cutoff).float().mean() > 0.99


def test_speech_masker_invariants():
    cfg = SpeechMaskConfig()
    ctx, tgt, vis = speech_masks(torch.Generator().manual_seed(2), 64, 200, cfg=cfg)
    assert torch.equal(vis, ctx[:, None, :] ^ tgt)
    assert not (tgt & ~ctx[:, None, :]).any()
    # context runs shorter than min_context_len were dropped
    runs = (~ctx).numpy().astype(int)
    edges = np.diff(np.pad(runs, ((0, 0), (1, 1))), axis=1)
    assert ((np.nonzero(edges == -1)[1] - np.nonzero(edges == 1)[1]) >= cfg.min_context_len).all()


def _reference_np(rng, batch, t, cfg):
    """The reference's rejection-loop masker in numpy (as tests/test_masking.py)."""
    ctx_rows, tgt_rows = [], []
    for _ in range(batch):
        while True:
            ctx_visible = ~sample_span_mask_np(rng, t, cfg.context_mask_prob,
                                               cfg.context_mask_length)
            targets = np.stack([sample_span_mask_np(rng, t, cfg.target_prob, cfg.target_length)
                                for _ in range(cfg.target_masks_per_context)])
            ctx_visible = ctx_visible & ~targets.any(0)
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


def test_distribution_matches_numpy_twin_and_jax():
    """The port's masker, the JAX masker and the reference's rejection loop
    (numpy twin) give the same visible-ratio and target-count
    distributions, at the thresholds of tests/test_masking.py."""
    cfg = TimeInverseMaskConfig()
    t = 200
    ctx_p, tgt_p, _ = time_inverse_block_masks(torch.Generator().manual_seed(11), 2048, t, cfg=cfg)
    ctx_p, tgt_p = ctx_p.numpy(), tgt_p.numpy()
    ctx_j, tgt_j, _ = jax_time_inverse(jax.random.PRNGKey(11), batch_size=2048, n_times=t,
                                       cfg=JaxTimeInverse())
    ctx_j, tgt_j = np.asarray(ctx_j), np.asarray(tgt_j)
    ctx_r, tgt_r = _reference_np(np.random.default_rng(11), 800, t, cfg)
    vr_p, vr_j, vr_r = ((~c).mean(axis=-1) for c in (ctx_p, ctx_j, ctx_r))
    for other in (vr_j, vr_r):
        assert abs(vr_p.mean() - other.mean()) < 0.02
        assert abs(vr_p.std() - other.std()) < 0.3 * other.std()
        assert _ks(vr_p, other) < 0.12
    tc_p, tc_j, tc_r = (g.sum(axis=-1).ravel().astype(float) for g in (tgt_p, tgt_j, tgt_r))
    for other in (tc_j, tc_r):
        assert abs(tc_p.mean() - other.mean()) < 0.05 * other.mean()
        assert _ks(tc_p, other) < 0.12


def test_masker_samples_on_the_generator_device_and_is_deterministic():
    cfg = dataclasses.replace(TimeInverseMaskConfig(), target_masks_per_context=2)
    a = time_inverse_block_masks(torch.Generator().manual_seed(3), 8, 200, cfg=cfg)
    b = time_inverse_block_masks(torch.Generator().manual_seed(3), 8, 200, cfg=cfg)
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x, y)
    assert format_mask(torch.tensor([True, False])) == "█·"
