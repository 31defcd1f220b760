"""The port's host resampler against the JAX package's: ``resample_np`` on
the port's own native build within 1e-6 (absolute) of the JAX package's
``resample_np`` at the rates shard audio arrives at, and within 2e-6
absolute plus 1e-5 relative (tests/test_resample_native.py's rtol) of its
plain scipy version; a short input, and identity at equal rates."""

import numpy as np
import pytest

from wavjepa_tpu.data.resample import resample_np as jax_resample_np
from wavjepa_tpu_torch.data import resample

RATES = [(44100, 16000), (48000, 16000), (32000, 16000), (22050, 16000), (8000, 16000)]


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_native_matches_the_jax_package_and_its_plain_version(sr_in, sr_out):
    rng = np.random.default_rng(sr_in % 97)
    x = rng.standard_normal((2, sr_in)).astype(np.float32)  # 1 s, two rows
    out = resample.resample_np(x, sr_in, sr_out)
    assert out.shape == (2, sr_out) and out.dtype == np.float32
    np.testing.assert_allclose(out, jax_resample_np(x, sr_in, sr_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, resample.resample_np_plain(x, sr_in, sr_out),
                               atol=2e-6, rtol=1e-5)


def test_kernel_is_the_jax_packages():
    from wavjepa_tpu.data.resample import _kaiser_sinc_kernel

    for sr_in, sr_out in RATES:
        k, L, M = resample._kaiser_sinc_kernel(sr_in, sr_out)
        jk, jl, jm = _kaiser_sinc_kernel(sr_in, sr_out)
        assert (L, M) == (jl, jm)
        np.testing.assert_array_equal(k, jk)


def test_short_input_and_leading_axes():
    """Shorter than the filter's half-width (≈ 1100 input samples at 44.1k),
    and (C, 1, T) leading axes kept."""
    x = np.random.default_rng(5).standard_normal((3, 1, 500)).astype(np.float32)
    out = resample.resample_np(x, 44100, 16000)
    assert out.shape == (3, 1, 182)
    np.testing.assert_allclose(out, jax_resample_np(x, 44100, 16000), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, resample.resample_np_plain(x, 44100, 16000),
                               atol=2e-6, rtol=1e-5)


def test_identity_at_equal_rates():
    x = np.random.default_rng(1).standard_normal((1, 100)).astype(np.float32)
    assert resample.resample_np(x, 16000, 16000) is x
    assert resample.resample_np_plain(x, 16000, 16000) is x


def test_tone_keeps_its_level():
    """A 1 kHz tone through 44.1k → 16k: unit gain away from the edges."""
    t = np.arange(44100) / 44100
    y = resample.resample_np(np.sin(2 * np.pi * 1000 * t).astype(np.float32)[None], 44100,
                             16000)[0]
    expect = np.sin(2 * np.pi * 1000 * np.arange(y.size) / 16000)
    np.testing.assert_allclose(y[200:-200], expect[200:-200], atol=1e-3)
