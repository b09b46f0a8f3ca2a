"""GeometricDelay (ops/geometric.py): beamforming delay math
(reference Signal/General/GeometricDelay.C)."""

import math

import numpy as np
import pytest

from dspsr_jax.ops.geometric import (
    GeometricDelay, source_unit_vector, C_M_PER_S)


def test_zenith_meridian_geometry():
    # source on meridian at dec=0: s = +X; only the X baseline delays
    g = GeometricDelay(np.array([[0.0, 0, 0], [1000.0, 0, 0]]),
                       hour_angle_rad=0.0, dec_rad=0.0)
    tau = g.delays_seconds()
    assert tau[0] == 0.0
    assert tau[1] == pytest.approx(1000.0 / C_M_PER_S)
    # east-west baseline sees no delay for a meridian source
    g2 = GeometricDelay(np.array([[0.0, 0, 0], [0.0, 1000.0, 0]]),
                        hour_angle_rad=0.0, dec_rad=0.0)
    assert g2.delays_seconds()[1] == pytest.approx(0.0, abs=1e-18)


def test_delay_rate_matches_numeric_derivative():
    b = np.array([[0.0, 0, 0], [2000.0, -500.0, 300.0]])
    h, d = 0.3, -0.7
    g = GeometricDelay(b, h, d)
    eps = 1e-6  # radians of hour angle
    from dspsr_jax.ops.geometric import OMEGA_EARTH
    gp = GeometricDelay(b, h + eps, d)
    gm = GeometricDelay(b, h - eps, d)
    num = (gp.delays_seconds() - gm.delays_seconds()) / (2 * eps) * OMEGA_EARTH
    np.testing.assert_allclose(g.delay_rate(), num, rtol=1e-6, atol=1e-22)


def test_integer_delay_and_response_phase():
    rate = 1e6
    g = GeometricDelay(np.array([[0.0, 0, 0], [3000.0, 0, 0]]),
                       hour_angle_rad=0.0, dec_rad=0.0)
    tau = g.delays_seconds()[1]  # ~10 us
    assert g.get_delay(0, 1, rate) == round(tau * rate)
    rr, ri = g.response(nchan=2, nfft=64, centre_frequency=1400.0,
                        bandwidth=8.0)
    assert rr.shape == (2, 2, 64)
    # reference stream: unit response
    np.testing.assert_allclose(rr[0], 1.0, atol=1e-7)
    np.testing.assert_allclose(ri[0], 0.0, atol=1e-7)
    # delayed stream: phase slope across the band equals -2 pi tau df
    ph = np.unwrap(np.arctan2(ri[1, 0], rr[1, 0]))
    df = (8.0 / 2 / 64) * 1e6  # Hz per bin
    slope = (ph[-1] - ph[0]) / (len(ph) - 1)
    expect = -2 * math.pi * df * tau
    # slope is wrapped mod 2pi per bin: compare on the circle
    assert math.remainder(slope - expect, 2 * math.pi) == pytest.approx(
        0.0, abs=1e-3)


def test_response_shifts_a_tone():
    """Applying the response to a tone's spectrum delays it by tau."""
    n = 4096
    rate = 1e6  # 1 MHz complex band at 100 MHz sky frequency
    cf, bw = 100.0, 1.0
    g = GeometricDelay(np.array([[0.0, 0, 0], [15000.0, 0, 0]]))
    tau = g.delays_seconds()[1]  # ~50 us = ~50 samples
    t = np.arange(n) / rate
    f_off = 12345.0  # Hz offset from band centre
    x = np.exp(2j * np.pi * f_off * t)
    rr, ri = g.response(1, n, cf, bw)
    resp = (rr[1, 0] + 1j * ri[1, 0])
    # natural-order response -> fftshift to match fft bin order
    spec = np.fft.fft(x)
    resp_fft = np.fft.ifftshift(resp)
    y = np.fft.ifft(spec * resp_fft)
    # expected: x delayed by tau and fringe-rotated at the sky frequency
    expect = np.exp(2j * np.pi * f_off * (t - tau)) * np.exp(
        -2j * np.pi * (cf * 1e6) * tau)
    m = slice(100, n - 100)  # ignore wrap edges
    err = np.abs(y[m] - expect[m]).max()
    assert err < 2e-2
