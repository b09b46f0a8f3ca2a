"""The split-complex FFT layer (ops.mxfft) against numpy.fft over lengths."""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.ops.mxfft import (
    fft_sc, fftshift_sc, ifft_sc, ifftshift_sc, rfft_sc)

LENGTHS = [2, 16, 256, 1 << 12, 1 << 16]


def _pair(z):
    return (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))


def _c(x):
    return np.asarray(x[0], np.float64) + 1j * np.asarray(x[1], np.float64)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft"])
def test_matches_numpy(rng, kind, n):
    batch = (3, 2)
    if kind == "rfft":
        x = rng.standard_normal((*batch, n))
        got = _c(rfft_sc(jnp.asarray(x, jnp.float32), n))
        want = np.fft.rfft(x, axis=-1)[..., : n // 2]
    else:
        z = rng.standard_normal((*batch, n)) + 1j * rng.standard_normal(
            (*batch, n))
        f = fft_sc if kind == "fft" else ifft_sc
        got = _c(f(_pair(z), n))
        want = (np.fft.fft if kind == "fft" else np.fft.ifft)(z, axis=-1)
    scale = np.abs(want).max()
    assert got.shape == want.shape
    # float32 transform error grows ~log2(n) ulps
    assert np.abs(got - want).max() / scale < 1e-5 * max(np.log2(n), 1)


@pytest.mark.parametrize("n", [8, 64])
def test_shifts_match_numpy(rng, n):
    z = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    np.testing.assert_array_equal(_c(fftshift_sc(_pair(z))),
                                  np.fft.fftshift(z.astype(np.complex64),
                                                  axes=-1))
    np.testing.assert_array_equal(_c(ifftshift_sc(_pair(z))),
                                  np.fft.ifftshift(z.astype(np.complex64),
                                                   axes=-1))


def test_length_mismatch_raises():
    with pytest.raises(ValueError):
        fft_sc((jnp.zeros((4, 8)), jnp.zeros((4, 8))), 16)
