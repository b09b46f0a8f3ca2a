"""Tests for MJD, polyco parsing, and phase prediction.

Regression targets: the shipped Vela polyco fixture
(/root/reference/Benchmark/vela.polyco) and internal consistency
(frequency == d(phase)/dt).
"""

import math

import numpy as np
import pytest

from dspsr_jax.timing.mjd import MJD
from dspsr_jax.timing.polyco import Polyco, FixedPeriodPredictor
from dspsr_jax.timing.par import Ephemeris


class TestMJD:
    def test_roundtrip(self):
        t = MJD.from_mjd(55299.10416666660)
        assert abs(t.in_days() - 55299.10416666660) < 1e-12

    def test_utc_parse(self):
        # 2010-04-13 is MJD 55299
        t = MJD.from_utc("2010-04-13-02:05:45")
        assert t.days == 55299
        assert abs(t.secs - (2 * 3600 + 5 * 60 + 45)) < 1e-9

    def test_arithmetic(self):
        a = MJD.from_utc("2010-04-13-00:00:00")
        b = a + 86400.0
        assert b.days == a.days + 1
        assert abs((b - a) - 86400.0) < 1e-9

    def test_normalization_negative(self):
        t = MJD(55299, -10.0)
        assert t.days == 55298
        assert abs(t.secs - 86390.0) < 1e-9

    def test_ordering(self):
        a = MJD(55299, 100.0)
        b = MJD(55299, 200.0)
        assert a < b and b > a and a <= a


class TestPolyco:
    def test_parse_vela(self, vela_polyco):
        assert len(vela_polyco.blocks) == 1
        b = vela_polyco.blocks[0]
        assert b.name == "0835-4510"
        assert abs(b.f0 - 11.194649939500) < 1e-12
        assert b.ncoef == 15
        assert b.span_minutes == 120
        assert abs(b.dm - 67.989998) < 1e-6
        assert abs(b.coefs[0] - 5.06097904229914526e-08) < 1e-20

    def test_phase_at_tmid(self, vela_polyco):
        b = vela_polyco.blocks[0]
        # at tmid, dt=0: phase = rphase + c[0]
        ph = b.phase(b.tmid)
        assert abs(ph - (b.rphase + b.coefs[0])) < 1e-6

    def test_frequency_is_phase_derivative(self, vela_polyco):
        b = vela_polyco.blocks[0]
        t = b.tmid + 600.0  # 10 min after tmid
        eps = 1e-3  # seconds
        # use fracturns (precision-preserving) for the numerical derivative;
        # absolute phase ~3.6e9 turns would lose ~1e-6 turns to roundoff
        dphi = (b.fracturns(t + eps) - b.fracturns(t - eps)) % 1.0
        dnum = dphi / (2 * eps)
        assert abs(dnum - b.frequency(t)) < 1e-6 * b.frequency(t)

    def test_fracturns_matches_phase(self, vela_polyco):
        b = vela_polyco.blocks[0]
        t = b.tmid + 123.456
        frac = b.fracturns(t)
        # full-phase fmod has ~1e-6 resolution at rphase~3.6e9; fracturns
        # should agree to that level while itself being much more precise
        full = b.phase(t)
        assert abs((full - math.floor(full)) - frac) % 1.0 < 1e-5
        assert 0.0 <= frac < 1.0

    def test_fracturns_precision(self, vela_polyco):
        # advancing time by exactly one period advances fracturns by ~1
        b = vela_polyco.blocks[0]
        t = b.tmid + 60.0
        p = 1.0 / b.frequency(t)
        f0 = b.fracturns(t)
        f1 = b.fracturns(t + p)
        dphi = (f1 - f0) % 1.0
        dphi = min(dphi, 1.0 - dphi)
        assert dphi < 1e-9

    def test_vela_period_sane(self, vela_polyco):
        t = vela_polyco.blocks[0].tmid
        p = vela_polyco.period(t)
        assert 0.089 < p < 0.090  # Vela ~89.3 ms

    def test_j0437_polyco(self):
        p = Polyco.load("/root/reference/Benchmark/polyco.dat")
        b = p.blocks[0]
        assert abs(b.f0 - 173.687948877644) < 1e-9
        assert b.binary_phase is not None
        t = b.tmid
        assert 0.00575 < 1.0 / b.frequency(t) < 0.00576  # J0437 ~5.757 ms

    def test_best_block_selection(self, vela_polyco):
        b = vela_polyco.blocks[0]
        assert vela_polyco.best_block(b.tmid) is b

    def test_phase_anchors(self, vela_polyco):
        b = vela_polyco.blocks[0]
        start = b.tmid
        tsamp = 1e-3
        anchors = vela_polyco.phase_anchors(start, tsamp, [0, 1000, 2000])
        assert anchors.shape == (3,)
        for i, off in enumerate([0, 1000, 2000]):
            assert abs(anchors[i] - b.fracturns(start + off * tsamp)) < 1e-12


class TestFixedPeriod:
    def test_cal_fold(self):
        pred = FixedPeriodPredictor(0.5, MJD(55000, 0.0))
        t = MJD(55000, 1.25)
        assert abs(pred.fracturns(t) - 0.5) < 1e-12
        assert pred.frequency(t) == 2.0


class TestEphemeris:
    def test_vela_par(self, vela_par):
        assert vela_par.name == "J0835-4510"
        assert abs(vela_par.dm - 67.99) < 1e-6
        assert abs(vela_par.f0 - 11.1946499395) < 1e-10
        assert vela_par.f1 == pytest.approx(-1.5666e-11)

    def test_period_at_epoch(self, vela_par):
        p = vela_par.period_at(vela_par.pepoch)
        assert 0.089 < p < 0.090


class TestBarycentre:
    """Solar-system Roemer delay (timing/barycentre.py): the correction
    TEMPO applies before the reference folds (Fold.C:229-267)."""

    def test_earth_orbit_geometry(self):
        from dspsr_jax.timing.barycentre import earth_position_au

        mjds = 55000.0 + np.arange(0, 366, 2.0)
        r = np.array([earth_position_au(m) for m in mjds])
        d = np.linalg.norm(r, axis=1)
        assert d.min() > 0.982 and d.max() < 1.018   # perihelion/aphelion
        # annual closure
        assert np.linalg.norm(earth_position_au(55000.0)
                              - earth_position_au(55000.0 + 365.2564)) < 0.01

    def test_equinox_sign_convention(self):
        from dspsr_jax.timing.barycentre import SSBDelay
        from dspsr_jax.timing.mjd import MJD

        # 2010 March equinox ~ MJD 55275.7: Sun at ecliptic longitude 0,
        # Earth at (-R, 0, 0); a pulsar at RA=0h, Dec=0 sits on +x, so the
        # delay is ~ -R * 499 s (pulses arrive LATE topocentrically)
        s = SSBDelay(0.0, 0.0)
        d = s.delay(MJD(55275, 0.7))
        assert -501.0 < d < -485.0, d

    def test_ecliptic_pole_small_delay(self):
        from dspsr_jax.timing.barycentre import SSBDelay
        from dspsr_jax.timing.mjd import MJD
        import math

        # north ecliptic pole: RA 18h, Dec +66.561 deg — the Earth's orbit
        # is perpendicular to the line of sight
        s = SSBDelay(math.pi * 1.5, math.radians(66.5607))
        ds = [abs(s.delay(MJD(55000 + k, 0.0))) for k in range(0, 366, 5)]
        assert max(ds) < 15.0, max(ds)

    def test_ecliptic_plane_full_amplitude(self):
        from dspsr_jax.timing.barycentre import SSBDelay
        from dspsr_jax.timing.mjd import MJD

        s = SSBDelay(0.0, 0.0)  # on the ecliptic (equinox point)
        ds = [s.delay(MJD(55000 + k, 0.0)) for k in range(0, 366, 2)]
        assert 485.0 < max(ds) < 512.0
        assert -512.0 < min(ds) < -485.0

    def test_spin_predictor_matches_tempo_polyco(self):
        """The barycentred .par spin model reproduces TEMPO's apparent
        frequency (vela.polyco, generated for Parkes) ~20x better than the
        topocentric model — an external cross-check against real TEMPO
        output."""
        from dspsr_jax.timing.par import Ephemeris
        from dspsr_jax.timing.polyco import Polyco, SpinPredictor
        from dspsr_jax.timing.mjd import MJD

        eph = Ephemeris.load("/root/reference/Benchmark/vela.par")
        pc = Polyco.load("/root/reference/Benchmark/vela.polyco")
        t = MJD.from_utc("2010-04-13-02:05:45")
        f_ref = pc.frequency(t)
        f_bary = SpinPredictor.from_ephemeris(eph).frequency(t)
        f_topo = SpinPredictor.from_ephemeris(eph,
                                              barycentre=False).frequency(t)
        err_b = abs(f_bary - f_ref)
        err_t = abs(f_topo - f_ref)
        # the Earth-orbit Doppler on Vela at this epoch is resolvable
        assert err_t > 1e-5, (err_t, f_topo, f_ref)
        assert err_b < err_t / 5.0, (err_b, err_t)
        # residual budget: site velocity (~1.5e-6 frac) + model terms
        assert err_b < 5e-5 * 11.19, err_b

    def test_site_velocity_term_improves_vs_tempo(self):
        """Adding the Parkes diurnal (site-velocity) term cuts the residual
        vs TEMPO's Parkes-specific polyco by another order of magnitude."""
        from dspsr_jax.timing.par import Ephemeris
        from dspsr_jax.timing.polyco import Polyco, SpinPredictor
        from dspsr_jax.timing.mjd import MJD

        eph = Ephemeris.load("/root/reference/Benchmark/vela.par")
        pc = Polyco.load("/root/reference/Benchmark/vela.polyco")
        errs_g, errs_s = [], []
        for k in range(9):
            t = MJD(55299, (0.104166 + k * 0.007) * 86400.0)
            f_ref = pc.frequency(t)
            errs_g.append(abs(SpinPredictor.from_ephemeris(
                eph).frequency(t) - f_ref))
            errs_s.append(abs(SpinPredictor.from_ephemeris(
                eph, telescope="PKS").frequency(t) - f_ref))
        assert max(errs_s) < max(errs_g) / 5.0
        assert max(errs_s) < 2e-6  # ~1e-7 fractional on Vela

    def test_observatory_position_geometry(self):
        from dspsr_jax.timing.barycentre import (observatory_position_au,
                                                 OBSERVATORIES,
                                                 _EARTH_R_AU)
        import numpy as np

        lat, lon, alt = OBSERVATORIES["PKS"]
        r0 = observatory_position_au(55000.0, lat, lon, alt)
        assert abs(np.linalg.norm(r0) - _EARTH_R_AU) < 0.01 * _EARTH_R_AU
        # one sidereal day later the site returns to the same place
        r1 = observatory_position_au(55000.0 + 0.9972696, lat, lon, alt)
        assert np.linalg.norm(r1 - r0) < 0.01 * _EARTH_R_AU
        # half a sidereal day: the equatorial components flip
        rh = observatory_position_au(55000.0 + 0.4986, lat, lon, alt)
        assert np.dot(rh[:2], r0[:2]) < 0
