"""The port's scene synthesis and device resampler against the JAX
package's, function by function, on the same seeded numpy inputs at 1, 2
and 4 channels. Tolerances as tests/test_scenes.py: atol 1e-3, rtol 1e-4
for the convolutions (f32 FFTs of other lengths: the port pads to a
7-smooth length, the JAX package to a multiple of 4096); the mixing and the
bank operations to f32 rounding. The resampler: the same sums in another
order, atol 1e-5 on unit-variance input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavjepa_tpu.data.pipeline import quantize_clip_int16
from wavjepa_tpu.data.resample import resample_jax
from wavjepa_tpu.ops import scenes as jsc
from wavjepa_tpu_torch.data.resample import resample_np_plain
from wavjepa_tpu_torch.ops.audio import wire_to_f32
from wavjepa_tpu_torch.ops import scenes as tsc
from wavjepa_tpu_torch.ops.resample import resample_torch

CONV = dict(atol=1e-3, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scene_inputs(seed, b=3, t=700, length=90, m=3, c=4):
    rng = np.random.default_rng(seed)
    rir = rng.standard_normal((b, c, length)).astype(np.float32) * 0.3
    rir[:, :, 0] = 1.0
    nrirs = rng.standard_normal((b, m, c, length)).astype(np.float32) * 0.3
    nrirs[:, -1] = 0.0  # an absent source
    return dict(
        source=rng.standard_normal((b, t)).astype(np.float32),
        source_rir=rir,
        noise=rng.standard_normal((b, t)).astype(np.float32),
        noise_rirs=nrirs,
        noise_start=np.array([0, 100, 350], np.int32)[:b],
        noise_length=np.array([t, 400, 200], np.int32)[:b],
        snr_db=rng.uniform(-5, 5, b).astype(np.float32),
    )


def test_fft_len_is_7_smooth_and_long_enough():
    assert tsc._fft_len(383999) == 384000 == 2**10 * 3 * 5**3  # the Nat scene shape
    for n in (1, 2, 11, 97, 463, 4097, 383999, 385025):
        m = tsc._fft_len(n)
        assert m >= n and tsc._smooth7(m)
        assert not any(tsc._smooth7(k) for k in range(n, m))  # the smallest


@pytest.mark.parametrize("t,length", [(400, 64), (5000, 700), (1000, 1)])
def test_fft_convolve_matches_jax_and_numpy(t, length):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t)).astype(np.float32)
    k = rng.standard_normal((3, length)).astype(np.float32)
    out = tsc.fft_convolve_full_trunc(_t(x), _t(k)).numpy()
    ref = np.asarray(jsc.fft_convolve_full_trunc(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(out, ref, **CONV)
    for i in range(3):
        np.testing.assert_allclose(out[i], np.convolve(x[i], k[i])[:t], **CONV)


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_convolutions_and_mixing_match_jax(channels):
    a = _scene_inputs(channels)
    c = channels
    wet = tsc.convolve_with_rir(_t(a["source"]), _t(a["source_rir"][:, :c])).numpy()
    np.testing.assert_allclose(
        wet, np.asarray(jsc.convolve_with_rir(a["source"], a["source_rir"][:, :c])), **CONV)
    bed = tsc.aggregate_noise(_t(a["noise_rirs"][:, :, :c]), _t(a["noise"])).numpy()
    np.testing.assert_allclose(
        bed, np.asarray(jsc.aggregate_noise(a["noise_rirs"][:, :, :c], a["noise"])), **CONV)
    mix_args = (a["snr_db"], a["noise_start"], a["noise_length"])
    mixed = tsc.add_noise(_t(wet), _t(bed), *map(_t, mix_args)).numpy()
    ref = np.asarray(jsc.add_noise(jnp.asarray(wet), jnp.asarray(bed), *mix_args))
    np.testing.assert_allclose(mixed, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("with_rir,with_noise", [(True, True), (True, False),
                                                 (False, True), (False, False)])
def test_generate_scene_matches_jax_in_each_case(channels, with_rir, with_noise):
    a = _scene_inputs(10 + channels)
    args = (a["source"], a["source_rir"], a["noise"], a["noise_rirs"], a["noise_start"],
            a["noise_length"], a["snr_db"])
    out = tsc.generate_scene(*map(_t, args), with_rir=with_rir, with_noise=with_noise,
                             n_channels=channels).numpy()
    ref = np.asarray(jsc.generate_scene(*map(jnp.asarray, args), with_rir=with_rir,
                                        with_noise=with_noise, n_channels=channels))
    assert out.shape == ref.shape == (3, channels, 700)
    np.testing.assert_allclose(out, ref, **CONV)


def test_segmental_snr_is_the_target():
    a = _scene_inputs(3, c=2)
    src = np.broadcast_to(a["source"][:, None], (3, 2, 700)).copy()
    nz = np.broadcast_to(a["noise"][:, None], (3, 2, 700)).copy()
    out = tsc.add_noise(_t(src), _t(nz), *map(_t, (a["snr_db"], a["noise_start"],
                                                  a["noise_length"]))).numpy()
    for i in range(3):
        s, n = a["noise_start"][i], a["noise_length"][i]
        sig, noise = src[i, :, s:s + n], (out - src)[i, :, s:s + n]
        snr = 10 * np.log10((sig**2).sum(-1) / (noise**2).sum(-1))
        np.testing.assert_allclose(snr, a["snr_db"][i], atol=1e-3)


def test_bank_gather_placement_and_refresh_match_jax():
    rng = np.random.default_rng(5)
    bank = {"source_rir": rng.standard_normal((5, 2, 30)).astype(np.float32),
            "noise_rirs": rng.standard_normal((5, 3, 2, 30)).astype(np.float32),
            "noise": np.stack([quantize_clip_int16(r) for r in
                               rng.standard_normal((4, 200)).astype(np.float32)])}
    idx, nidx = np.array([4, 0, 4], np.int32), np.array([1, 3, 0], np.int32)
    start = np.array([0, 17, 199], np.int32)
    tbank = {k: _t(v) for k, v in bank.items()}
    for got, want in zip(tsc.gather_scene_rirs(tbank, _t(idx)),
                         jsc.gather_scene_rirs(bank, jnp.asarray(idx))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    placed = tsc.place_noise_from_bank(tbank["noise"], _t(nidx), _t(start))
    ref = jsc.place_noise_from_bank(jnp.asarray(bank["noise"]), jnp.asarray(nidx),
                                    jnp.asarray(start))
    assert placed.dtype == torch.float32
    np.testing.assert_allclose(placed.numpy(), np.asarray(ref), rtol=1e-7)

    # a refresh: int16 noise rows into the int16 bank as they are, f32 RIRs,
    # and int16 rows into an f32 bank through the wire scale
    slots = {"source_rir": np.array([1, 3], np.int32), "noise": np.array([2], np.int32)}
    rows = {"source_rir": rng.standard_normal((2, 2, 30)).astype(np.float32),
            "noise": quantize_clip_int16(rng.standard_normal((1, 200)).astype(np.float32))}
    ref = jsc.update_rir_bank({k: jnp.asarray(v) for k, v in bank.items()},
                              {k: jnp.asarray(v) for k, v in slots.items()},
                              {k: jnp.asarray(v) for k, v in rows.items()})
    out = tsc.update_rir_bank(tbank, {k: _t(v) for k, v in slots.items()},
                              {k: _t(v) for k, v in rows.items()})
    assert out is tbank and tbank["noise"].dtype == torch.int16  # in place
    for k in bank:
        np.testing.assert_array_equal(tbank[k].numpy(), np.asarray(ref[k]))
    f32_bank = {"noise": torch.zeros(4, 200)}
    tsc.update_rir_bank(f32_bank, {"noise": _t(slots["noise"])}, {"noise": _t(rows["noise"])})
    np.testing.assert_allclose(f32_bank["noise"][2].numpy(), rows["noise"][0] / 32767.0,
                               rtol=1e-7)


def test_wire_format_is_undone_as_the_jax_scenes_do():
    x = np.array([[32767, -32767, 0, 5]], np.int16)
    np.testing.assert_array_equal(wire_to_f32(_t(x)).numpy(),
                                  np.asarray(jsc.wire_to_f32(jnp.asarray(x))))


@pytest.mark.parametrize("sr_in,sr_out,t", [
    (32000, 16000, 3217),  # the Nat step's rate, L = 1
    (16000, 24000, 1601),  # L = 3, M = 2
    (44100, 16000, 4410),  # L = 160, M = 441
])
def test_device_resampler_matches_resample_jax(sr_in, sr_out, t):
    x = np.random.default_rng(t).standard_normal((2, 2, t)).astype(np.float32)
    out = resample_torch(_t(x), sr_in, sr_out).numpy()
    ref = np.asarray(resample_jax(x, sr_in, sr_out))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # and the scipy plain version the card phase holds it against
    np.testing.assert_allclose(out, resample_np_plain(x, sr_in, sr_out), atol=1e-5)


def test_device_resampler_at_equal_rates_is_the_input():
    x = torch.ones(1, 2, 10)
    assert resample_torch(x, 16000, 16000) is x
