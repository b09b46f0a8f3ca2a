"""Binary pulsar orbital models: Roemer-delay correction for folding.

Equivalent of the orbital part of TEMPO's phase prediction that the
reference consumes through ``Pulsar::Predictor`` (it shells out to
TEMPO/TEMPO2, ``Signal/Pulsar/Fold.C:229-267``, so binary terms live in the
generated polyco).  When dspsr_jax folds directly from a ``.par`` ephemeris
(no polyco), these models supply the orbital pulse-arrival-time delay so
binary pulsars (e.g. the reference benchmark source J0437-4715,
``Benchmark/pulsar.par`` BINARY T2) fold coherently: the pulse phase is the
spin model evaluated at the *emission* time t - delay(t).

Implemented models (the two that cover nearly all timed binaries):

- **BT** (Blandford & Teukolsky 1976): full Keplerian orbit.  Parameters
  PB [days], T0 [MJD], A1 = a.sin(i)/c [light-s], OM [deg], ECC, and the
  secular terms PBDOT, OMDOT [deg/yr], XDOT, EDOT, plus the Einstein GAMMA.
      M = 2 pi ((t-T0)/PB - PBDOT/2 ((t-T0)/PB)^2)
      E - e sin E = M                       (Kepler, Newton-solved)
      delay = x [(cos E - e) sin w + sin E sqrt(1-e^2) cos w] + GAMMA sin E
- **ELL1** (Lange et al. 2001): low-eccentricity parametrization used for
  most millisecond binaries.  Parameters PB, TASC [MJD], A1,
  EPS1 = e.sin(w), EPS2 = e.cos(w) (+PBDOT, XDOT, EPS1DOT, EPS2DOT):
      Phi = 2 pi ((t-TASC)/PB - PBDOT/2 ((t-TASC)/PB)^2)
      delay = x [sin Phi + (k/2) sin 2Phi - (h/2) cos 2Phi]   (O(e) exact)
  with h = EPS1, k = EPS2.

Models named DD/DDK/DDGR/T2 in par files are evaluated with the BT
Keplerian delay (the dominant Roemer + Einstein terms); the Shapiro delay
(~microseconds) is far below a phase bin for folding purposes.  All math is
host-side float64, mirroring the reference's double-precision timing path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from .mjd import MJD

_SECS_PER_DAY = 86400.0
_SECS_PER_YEAR = 365.25 * _SECS_PER_DAY
_DEG = math.pi / 180.0


@dataclass
class BTModel:
    """Keplerian orbit (BT); also used for DD-family and T2 par files."""

    pb: float           # orbital period [s]
    t0: MJD             # epoch of periastron
    a1: float           # projected semi-major axis [light-s]
    om: float = 0.0     # longitude of periastron [rad]
    ecc: float = 0.0
    pbdot: float = 0.0  # dimensionless (s/s)
    omdot: float = 0.0  # [rad/s]
    xdot: float = 0.0   # [light-s/s]
    edot: float = 0.0   # [1/s]
    gamma: float = 0.0  # Einstein delay amplitude [s]

    def roemer_delay(self, t: MJD) -> float:
        """Orbital delay [s] at topocentric time t (Roemer + Einstein)."""
        dt = t - self.t0  # seconds
        norbits = dt / self.pb - 0.5 * self.pbdot * (dt / self.pb) ** 2
        m = 2.0 * math.pi * (norbits - math.floor(norbits))
        e = self.ecc + self.edot * dt
        x = self.a1 + self.xdot * dt
        w = self.om + self.omdot * dt
        # Kepler's equation, Newton-Raphson (converges in ~4 iters for e<0.9)
        big_e = m if e < 0.8 else math.pi
        for _ in range(20):
            f = big_e - e * math.sin(big_e) - m
            big_e -= f / (1.0 - e * math.cos(big_e))
            if abs(f) < 1e-14:
                break
        se, ce = math.sin(big_e), math.cos(big_e)
        return (x * ((ce - e) * math.sin(w) + se * math.sqrt(1.0 - e * e) * math.cos(w))
                + self.gamma * se)


@dataclass
class ELL1Model:
    """Low-eccentricity Laplace-Lagrange orbit (Lange et al. 2001)."""

    pb: float            # orbital period [s]
    tasc: MJD            # epoch of ascending node
    a1: float            # projected semi-major axis [light-s]
    eps1: float = 0.0    # e sin(omega)
    eps2: float = 0.0    # e cos(omega)
    pbdot: float = 0.0
    xdot: float = 0.0
    eps1dot: float = 0.0  # [1/s]
    eps2dot: float = 0.0  # [1/s]

    def roemer_delay(self, t: MJD) -> float:
        dt = t - self.tasc  # seconds
        norbits = dt / self.pb - 0.5 * self.pbdot * (dt / self.pb) ** 2
        phi = 2.0 * math.pi * (norbits - math.floor(norbits))
        x = self.a1 + self.xdot * dt
        h = self.eps1 + self.eps1dot * dt  # e sin w
        k = self.eps2 + self.eps2dot * dt  # e cos w
        return x * (math.sin(phi)
                    + 0.5 * k * math.sin(2.0 * phi)
                    - 0.5 * h * math.cos(2.0 * phi))


def from_ephemeris(eph) -> Optional[object]:
    """Build the orbital model named by a parsed ``.par`` ephemeris.

    Returns None for isolated pulsars.  Unknown BINARY names fall back to
    the Keplerian BT evaluation when T0/OM/ECC are present, or ELL1 when
    TASC/EPS1/EPS2 are (T2-model par files may use either convention).
    """
    model = (eph.get("BINARY") or "").upper()
    if not model and not eph.get("PB"):
        return None

    def fget(key, default=0.0):
        v = eph.get(key)
        if v is None:
            return default
        return float(str(v).replace("D", "E").replace("d", "e"))

    pb = fget("PB")
    if pb == 0.0:
        return None
    pb_s = pb * _SECS_PER_DAY
    a1 = fget("A1")
    pbdot = fget("PBDOT")
    if abs(pbdot) > 1e-7:   # TEMPO convention: small values given in 1e-12
        pbdot *= 1e-12
    xdot = fget("XDOT")
    if abs(xdot) > 1e-7:
        xdot *= 1e-12

    use_ell1 = model == "ELL1" or (eph.get("TASC") is not None
                                   and eph.get("T0") is None)
    if use_ell1:
        return ELL1Model(
            pb=pb_s, tasc=MJD.from_mjd(fget("TASC")), a1=a1,
            eps1=fget("EPS1"), eps2=fget("EPS2"),
            pbdot=pbdot, xdot=xdot,
            eps1dot=fget("EPS1DOT"), eps2dot=fget("EPS2DOT"),
        )
    return BTModel(
        pb=pb_s, t0=MJD.from_mjd(fget("T0")), a1=a1,
        om=fget("OM") * _DEG, ecc=fget("ECC") or fget("E"),
        pbdot=pbdot,
        omdot=fget("OMDOT") * _DEG / _SECS_PER_YEAR,
        xdot=xdot, edot=fget("EDOT"),
        gamma=fget("GAMMA"),
    )
