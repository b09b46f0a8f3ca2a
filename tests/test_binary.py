"""Binary orbital models (timing/binary.py): BT vs ELL1 consistency and
SpinPredictor integration (reference: TEMPO binary terms consumed via
Pulsar::Predictor, Signal/Pulsar/Fold.C:229-267)."""

import math

import numpy as np
import pytest

from dspsr_jax.timing import binary
from dspsr_jax.timing.binary import BTModel, ELL1Model
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.timing.par import Ephemeris
from dspsr_jax.timing.polyco import SpinPredictor

PB_D = 5.7410459  # J0437-like orbital period [days]
PB_S = PB_D * 86400.0
A1 = 3.3666787
T0 = MJD.from_mjd(54501.4671)


def test_circular_orbit_is_sinusoid():
    bt = BTModel(pb=PB_S, t0=T0, a1=A1, om=0.0, ecc=0.0)
    for frac in (0.0, 0.13, 0.25, 0.5, 0.77):
        t = T0 + frac * PB_S
        assert bt.roemer_delay(t) == pytest.approx(
            A1 * math.sin(2 * math.pi * frac), abs=1e-12)


def test_ell1_matches_bt_at_low_eccentricity():
    ecc, om = 1.3e-4, 1.1  # rad
    # periastron follows the ascending node by om of orbital phase
    tasc = T0 - (om / (2 * math.pi)) * PB_S
    bt = BTModel(pb=PB_S, t0=T0, a1=A1, om=om, ecc=ecc)
    ell1 = ELL1Model(pb=PB_S, tasc=tasc, a1=A1,
                     eps1=ecc * math.sin(om), eps2=ecc * math.cos(om))
    # ELL1 (TEMPO2 convention) omits the constant -(3/2) x e sin(om) term
    # that BT carries (it is unobservable: absorbed into TASC).
    const = -1.5 * A1 * ecc * math.sin(om)
    for frac in np.linspace(0.0, 2.0, 17):
        t = T0 + frac * PB_S
        # agreement to O(x e^2) ~ 6e-8 light-s after the constant
        assert ell1.roemer_delay(t) + const == pytest.approx(
            bt.roemer_delay(t), abs=10 * A1 * ecc**2)


def test_kepler_solution_high_eccentricity():
    bt = BTModel(pb=PB_S, t0=T0, a1=A1, om=0.4, ecc=0.85)
    # E - e sin E = M must hold at the solved E; verify via inversion:
    # reconstruct delay at many phases and check continuity + bounds
    d = [bt.roemer_delay(T0 + f * PB_S) for f in np.linspace(0, 1, 1001)]
    assert max(abs(np.diff(d))) < A1 * 0.1   # smooth
    assert max(np.abs(d)) <= A1 * (1 + 1e-9)  # |delay| <= x


def test_spin_predictor_phase_shift_and_doppler():
    f0 = 173.688  # Hz
    pred_iso = SpinPredictor(f0, pepoch=T0)
    orb = BTModel(pb=PB_S, t0=T0, a1=A1, om=0.3, ecc=0.01)
    pred_bin = SpinPredictor(f0, pepoch=T0, binary=orb)
    t = T0 + 0.31 * PB_S
    dphase = pred_bin.phase(t) - pred_iso.phase(t)
    assert dphase == pytest.approx(-f0 * orb.roemer_delay(t), rel=1e-9)
    # apparent spin frequency carries the orbital Doppler factor
    ddot = (orb.roemer_delay(t + 1.0) - orb.roemer_delay(t - 1.0)) / 2.0
    assert pred_bin.frequency(t) == pytest.approx(f0 * (1 - ddot), rel=1e-12)
    # fracturns consistent with phase model
    fr = pred_bin.fracturns(t)
    assert fr == pytest.approx(pred_bin.phase(t) % 1.0, abs=1e-6)


def test_from_ephemeris_ell1_and_bt():
    eph = Ephemeris.parse(f"""
PSRJ J0437-4715
F0 173.6879458121843
F1 -1.728358e-15
PEPOCH 54500.0
DM 2.64476
BINARY ELL1
PB {PB_D}
A1 {A1}
TASC 54501.4671
EPS1 1.9e-5
EPS2 1.2e-5
""")
    m = binary.from_ephemeris(eph)
    assert isinstance(m, ELL1Model)
    assert m.pb == pytest.approx(PB_S)
    p = SpinPredictor.from_ephemeris(eph)
    assert p.binary is m.__class__(**vars(m)) or p.binary is not None

    eph2 = Ephemeris.parse("""
PSRJ J1141-6545
F0 2.5387230404
PEPOCH 51369.8
BINARY BT
PB 0.1976509593
A1 1.858922
T0 51369.854552
OM 42.457
ECC 0.171884
""")
    m2 = binary.from_ephemeris(eph2)
    assert isinstance(m2, BTModel)
    assert m2.ecc == pytest.approx(0.171884)
    assert m2.om == pytest.approx(42.457 * math.pi / 180)


def test_isolated_pulsar_has_no_binary():
    eph = Ephemeris.parse("PSRJ J0835-4510\nF0 11.19\nPEPOCH 50000\n")
    assert binary.from_ephemeris(eph) is None
    assert SpinPredictor.from_ephemeris(eph).binary is None
