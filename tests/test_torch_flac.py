"""The port's native FLAC decoder (its own build of
``data/_native/flac_decoder.cc``) against the JAX package's build, on the
payloads that tests/test_flac.py encodes: every subframe type and stereo
decorrelation, equal samples (bit for bit) and equal rate."""

import numpy as np
import pytest

from tests.test_flac import (
    _smooth,
    encode_flac,
    write_constant,
    write_fixed,
    write_fixed_rice,
    write_lpc,
    write_verbatim,
)
from wavjepa_tpu.data._native import flac_native as jax_flac
from wavjepa_tpu.data.decode import decode_audio as jax_decode_audio
from wavjepa_tpu_torch.data import flac
from wavjepa_tpu_torch.data.decode import decode_audio


def _verbatim():
    x = np.random.default_rng(0).integers(-32768, 32767, size=512, dtype=np.int64)
    return encode_flac([[lambda w: write_verbatim(w, x[:256], 16)],
                        [lambda w: write_verbatim(w, x[256:], 16)]], sr=44100)


def _constant():
    return encode_flac([[lambda w: write_constant(w, -1234, 16)]])


def _fixed_rice(order, k):
    rng = np.random.default_rng(order * 10 + k)
    t = np.arange(256)
    x = (1000 * np.sin(t / 17.0) + rng.integers(-20, 20, 256)).astype(np.int64)
    return encode_flac([[lambda w: write_fixed_rice(w, x, 16, order, k)]], sr=48000)


def _stereo(ch_code):
    rng = np.random.default_rng(ch_code)
    left = _smooth(rng, 256)
    right = _smooth(rng, 256) // 2
    if ch_code == 1:  # independent
        subframes = [lambda w: write_verbatim(w, left, 16),
                     lambda w: write_verbatim(w, right, 16)]
    elif ch_code == 8:  # left/side
        subframes = [lambda w: write_verbatim(w, left, 16),
                     lambda w: write_verbatim(w, left - right, 17)]
    elif ch_code == 9:  # right/side
        subframes = [lambda w: write_lpc(w, left - right, 17, 1, [32], 5, precision=8, ks=(9,)),
                     lambda w: write_fixed(w, right, 16, 1, ks=(9,))]
    else:  # 10: mid/side
        subframes = [lambda w: write_fixed(w, (left + right) >> 1, 16, 2, ks=(9,)),
                     lambda w: write_fixed(w, left - right, 17, 2, ks=(9,))]
    return encode_flac([subframes], channels=2, ch_code=ch_code)


def _lpc(order):
    x = _smooth(np.random.default_rng(order), 256)
    coefs = [32] + [0] * (order - 1)
    return encode_flac([[lambda w: write_lpc(w, x, 16, order, coefs, 5, precision=8, ks=(9,))]])


def _mixed():
    rng = np.random.default_rng(15)
    xs = [_smooth(rng, 256) for _ in range(4)]
    return encode_flac([
        [lambda w: write_lpc(w, xs[0], 16, 8, [32, -8, 4, -2, 1, 0, 0, 1], 5, precision=8,
                             ks=(9,))],
        [lambda w: write_fixed(w, xs[1], 16, 3, ks=(9,))],
        [lambda w: write_verbatim(w, xs[2], 16)],
        [lambda w: write_fixed(w, xs[3], 16, 4, partition_order=1, ks=(9, 9))],
    ])


def _wasted_escape():
    x = _smooth(np.random.default_rng(16), 256) * 4
    return encode_flac([[lambda w: write_fixed(w, x, 16, 2, wasted=2, method=1,
                                               escape_raw_bits=16, ks=(0,))]])


PAYLOADS = {
    "verbatim": _verbatim, "constant": _constant,
    **{f"fixed_rice_o{o}_k{k}": (lambda o=o, k=k: _fixed_rice(o, k))
       for o in (0, 1, 2) for k in (0, 2, 6)},
    **{f"stereo_{name}": (lambda c=c: _stereo(c))
       for name, c in (("independent", 1), ("left_side", 8), ("right_side", 9),
                       ("mid_side", 10))},
    **{f"lpc_o{o}": (lambda o=o: _lpc(o)) for o in (1, 8, 32)},
    "mixed_subframes": _mixed, "wasted_bits_escape": _wasted_escape,
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_decoder_matches_the_jax_package_bit_for_bit(name):
    data = PAYLOADS[name]()
    want, want_sr = jax_flac.decode(data)
    got, got_sr = flac.decode(data)
    assert got_sr == want_sr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the dispatch by extension reaches the same decoder
    via, via_sr = decode_audio({"flac": data})
    jax_via, _ = jax_decode_audio({"flac": data})
    assert via_sr == got_sr
    np.testing.assert_array_equal(via, jax_via)


@pytest.mark.parametrize("payload", [b"not a flac stream at all", b"fLaC" + b"\x00" * 8, b""])
def test_garbage_raises(payload):
    with pytest.raises(ValueError, match="FLAC decode failed"):
        flac.decode(payload)
