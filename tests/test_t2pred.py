"""TEMPO2 ChebyModelSet (T2) predictor tests.

Validates the Cheby2D evaluator against the polyco it was fitted from
(reference parity: both are Pulsar::Predictor backends selected by -P,
``Signal/Pulsar/Fold.C:229-267``).
"""

import math

import numpy as np
import pytest

from dspsr_jax.timing.mjd import MJD
from dspsr_jax.timing.polyco import Polyco
from dspsr_jax.timing.t2pred import (
    T2Predictor, fit_cheby_model, generate_from_predictor, load_predictor,
)

VELA_POLYCO = "/root/reference/Benchmark/vela.polyco"


@pytest.fixture(scope="module")
def vela():
    return Polyco.load(VELA_POLYCO)


def _trange(poly, minutes=20.0):
    t0 = poly.blocks[0].tmid
    a = t0.days + t0.fracday()
    return a, a + minutes / 1440.0


def test_fit_matches_polyco_phase(vela):
    a, b = _trange(vela)
    t2 = generate_from_predictor(
        vela, a, b, 1182.0, 1582.0, dm=vela.blocks[0].dm,
        reference_freq=vela.blocks[0].obsfreq,
        ncoeff_time=16, psrname="vela", sitename="pks")
    t2.obsfreq = vela.blocks[0].obsfreq
    rng = np.random.default_rng(0)
    for frac in rng.uniform(0.02, 0.98, size=12):
        t = MJD(int(a), (a - int(a)) * 86400.0) + frac * (b - a) * 86400.0
        ph_ref = vela.phase(t)
        ph_t2 = t2.phase(t)
        # absolute phase is ~1.4e10 turns, so float64 ulp is ~2e-6 turns;
        # the fit is exact to machine resolution of the absolute phase
        assert abs(ph_t2 - ph_ref) < 8e-6
        assert abs(t2.frequency(t) - vela.frequency(t)) < 1e-6 * vela.frequency(t)


def test_dispersion_term_moves_phase_with_freq(vela):
    a, b = _trange(vela)
    dm = vela.blocks[0].dm
    fref = vela.blocks[0].obsfreq
    t2 = generate_from_predictor(vela, a, b, 1182.0, 1582.0, dm=dm,
                                 reference_freq=fref, ncoeff_time=16,
                                 ncoeff_freq=3)
    t = MJD(int(a), (a - int(a)) * 86400.0) + 300.0
    m = t2.best_model(t)
    f_lo, f_hi = 1200.0, 1500.0
    dphi = m.phase(t, f_hi) - m.phase(t, f_lo)
    # expected: phase(f) = base(t - kdm*DM*(1/f^2 - 1/fref^2)) so
    # dphi ~ F0 * kdm * DM * (1/f_lo^2 - 1/f_hi^2)
    kdm = 1.0 / 2.41e-4
    expect = vela.frequency(t) * kdm * dm * (1.0 / f_lo**2 - 1.0 / f_hi**2)
    assert abs(dphi - expect) < 2e-3 * abs(expect)


def test_roundtrip_file(tmp_path, vela):
    a, b = _trange(vela)
    t2 = generate_from_predictor(vela, a, b, 1182.0, 1582.0,
                                 dm=vela.blocks[0].dm, ncoeff_time=14,
                                 segment_minutes=10.0)
    assert len(t2.models) == 2
    p = tmp_path / "t2pred.dat"
    t2.save(str(p))
    t2b = load_predictor(str(p))
    t2b.obsfreq = t2.obsfreq
    t = MJD(int(a), (a - int(a)) * 86400.0) + 0.3 * (b - a) * 86400.0
    assert t2b.phase(t) == pytest.approx(t2.phase(t), abs=1e-9)
    np.testing.assert_allclose(t2b.models[0].coefs, t2.models[0].coefs)
    # polyco path of the same factory
    assert isinstance(load_predictor(VELA_POLYCO), Polyco)


def test_fracturns_consistent(vela):
    a, b = _trange(vela)
    t2 = generate_from_predictor(vela, a, b, 1182.0, 1582.0,
                                 dm=vela.blocks[0].dm, ncoeff_time=16,
                                 reference_freq=vela.blocks[0].obsfreq)
    t2.obsfreq = vela.blocks[0].obsfreq
    t = MJD(int(a), (a - int(a)) * 86400.0) + 123.456
    f = t2.fracturns(t)
    assert 0.0 <= f < 1.0
    d_ref = abs(f - vela.fracturns(t))
    assert min(d_ref, 1.0 - d_ref) < 1e-5


def test_segment_selection(vela):
    a, b = _trange(vela, minutes=30.0)
    t2 = generate_from_predictor(vela, a, b, 1182.0, 1582.0,
                                 dm=vela.blocks[0].dm, segment_minutes=10.0,
                                 ncoeff_time=14)
    assert len(t2.models) == 3
    t = MJD(int(a), (a - int(a)) * 86400.0) + 15.0 * 60.0
    m = t2.best_model(t)
    assert m.covers(t)
