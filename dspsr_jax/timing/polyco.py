"""TEMPO polyco parsing and pulse-phase prediction.

Equivalent of PSRCHIVE's ``Pulsar::Predictor`` / ``polyco`` used by
the reference for folding (``Signal/Pulsar/Fold.C:229-267`` generates the
predictor; ``Fold.C:943-958`` evaluates ``phase(MJD)`` and ``frequency(MJD)``).

A TEMPO polyco set is one or more blocks of the form::

    0835-4510  13-APR-10   230000.00  55299.10416666660   67.989998  0.359 -7.192
       3616377136.814839   11.194649939500    7  120   15  1382.000
     +5.06097904229914526D-08 -3.24588035865896740D-01 ...  (ncoef values)

Line 1: name, date, UTC (hhmmss.ss), TMID (MJD), DM, Doppler (1e-4), log10(rms).
Line 2: RPHASE, F0 (Hz), observatory code, span (minutes), ncoef, obsfreq (MHz)
        [, binary phase, binary freq].
Then ceil(ncoef/3) lines of coefficients in Fortran D-exponent notation.

Phase model (TEMPO conventions)::

    dt   = (t - tmid) in minutes
    phase(t) = rphase + dt*60*f0 + c[0] + c[1]*dt + c[2]*dt^2 + ...
    freq(t)  = f0 + (1/60) * (c[1] + 2*c[2]*dt + 3*c[3]*dt^2 + ...)   [Hz]

All evaluation is float64 on the host; the device only ever sees small
per-segment fractional-phase anchors (see ops.fold).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from .mjd import MJD


@dataclass
class PolycoBlock:
    """One polyco span."""

    name: str
    tmid: MJD
    dm: float
    doppler: float
    log10_rms: float
    rphase: float
    f0: float
    obs: str
    span_minutes: float
    ncoef: int
    obsfreq: float
    coefs: np.ndarray  # float64[ncoef]
    binary_phase: float | None = None
    binary_freq: float | None = None

    def covers(self, t: MJD) -> bool:
        half = self.span_minutes * 60.0 / 2.0
        dt = t - self.tmid
        return -half <= dt <= half

    def _dt_minutes(self, t: MJD) -> float:
        return (t - self.tmid) / 60.0

    def phase(self, t: MJD) -> float:
        """Absolute pulse phase in turns (float64)."""
        dt = self._dt_minutes(t)
        p = float(np.polyval(self.coefs[::-1], dt))
        return self.rphase + dt * 60.0 * self.f0 + p

    def fracturns(self, t: MJD) -> float:
        """Fractional part of phase, carefully avoiding catastrophic loss.

        rphase can be ~1e10 turns; split integer/fractional parts before
        summing so the returned fraction retains full float64 resolution.
        """
        dt = self._dt_minutes(t)
        poly = float(np.polyval(self.coefs[::-1], dt))
        spin = dt * 60.0 * self.f0
        f = (
            math.fmod(self.rphase, 1.0)
            + math.fmod(spin, 1.0)
            + math.fmod(poly, 1.0)
        )
        return f - math.floor(f)

    def frequency(self, t: MJD) -> float:
        """Apparent spin frequency in Hz."""
        dt = self._dt_minutes(t)
        c = self.coefs
        dpoly = 0.0
        for i in range(len(c) - 1, 0, -1):
            dpoly = dpoly * dt + i * c[i]
        return self.f0 + dpoly / 60.0


@dataclass
class Polyco:
    """A set of polyco blocks; equivalent to PSRCHIVE ``polyco`` (Predictor)."""

    blocks: List[PolycoBlock] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Polyco":
        with open(path) as f:
            return cls.parse(f.read())

    @classmethod
    def parse(cls, text: str) -> "Polyco":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        blocks: List[PolycoBlock] = []
        i = 0
        while i < len(lines):
            hdr = lines[i].split()
            if len(hdr) < 6:
                raise ValueError(f"bad polyco header line: {lines[i]!r}")
            name = hdr[0]
            tmid = MJD.from_mjd(float(hdr[3]))
            dm = float(hdr[4])
            doppler = float(hdr[5]) if len(hdr) > 5 else 0.0
            log10_rms = float(hdr[6]) if len(hdr) > 6 else 0.0
            i += 1
            l2 = lines[i].split()
            rphase = float(l2[0])
            f0 = float(l2[1])
            obs = l2[2]
            span = float(l2[3])
            ncoef = int(l2[4])
            obsfreq = float(l2[5])
            binary_phase = float(l2[6]) if len(l2) > 6 else None
            binary_freq = float(l2[7]) if len(l2) > 7 else None
            i += 1
            coefs: List[float] = []
            while len(coefs) < ncoef:
                for tok in lines[i].split():
                    coefs.append(float(tok.replace("D", "E").replace("d", "e")))
                i += 1
            blocks.append(
                PolycoBlock(
                    name=name,
                    tmid=tmid,
                    dm=dm,
                    doppler=doppler,
                    log10_rms=log10_rms,
                    rphase=rphase,
                    f0=f0,
                    obs=obs,
                    span_minutes=span,
                    ncoef=ncoef,
                    obsfreq=obsfreq,
                    coefs=np.asarray(coefs, dtype=np.float64),
                    binary_phase=binary_phase,
                    binary_freq=binary_freq,
                )
            )
        return cls(blocks)

    def best_block(self, t: MJD) -> PolycoBlock:
        covering = [b for b in self.blocks if b.covers(t)]
        pool = covering or self.blocks
        if not pool:
            raise ValueError("empty polyco")
        best = min(pool, key=lambda b: abs(t - b.tmid))
        if not covering:
            # tolerate modest overshoot past the span edge (TEMPO spans are
            # generated to bracket the observation, but edges can clip); a
            # gross extrapolation would return silent garbage phase, so
            # refuse it like the reference predictor does
            overshoot = abs(t - best.tmid) - best.span_minutes * 60.0 / 2.0
            if overshoot > best.span_minutes * 60.0 / 2.0:
                raise ValueError(
                    f"MJD {t} is {overshoot/60.0:.1f} min outside every "
                    f"polyco span (nearest tmid {best.tmid})")
        return best

    # ---- Predictor interface (reference Pulsar::Predictor) ----

    def phase(self, t: MJD) -> float:
        return self.best_block(t).phase(t)

    def fracturns(self, t: MJD) -> float:
        return self.best_block(t).fracturns(t)

    def frequency(self, t: MJD) -> float:
        return self.best_block(t).frequency(t)

    def period(self, t: MJD) -> float:
        return 1.0 / self.frequency(t)

    def phase_anchors(self, start: MJD, tsamp: float, offsets: Sequence[int]) -> np.ndarray:
        """Fractional phase at ``start + offsets[i]*tsamp`` for each offset.

        Used to anchor on-device linear phase segments (float64 host math).
        """
        out = np.empty(len(offsets), dtype=np.float64)
        for i, off in enumerate(offsets):
            out[i] = self.fracturns(start + off * tsamp)
        return out


class FixedPeriodPredictor:
    """Folding at a constant topocentric period (reference ``Fold::folding_period``,
    ``Fold.C:943-947``), e.g. for CAL square waves."""

    def __init__(self, period: float, reference_epoch: MJD | None = None):
        self.folding_period = float(period)
        self.reference_epoch = reference_epoch or MJD(0, 0.0)

    def fracturns(self, t: MJD) -> float:
        ph = math.fmod(t - self.reference_epoch, self.folding_period) / self.folding_period
        return ph - math.floor(ph)

    def phase(self, t: MJD) -> float:
        return (t - self.reference_epoch) / self.folding_period

    def frequency(self, t: MJD) -> float:
        return 1.0 / self.folding_period

    def period(self, t: MJD) -> float:
        return self.folding_period

    def phase_anchors(self, start: MJD, tsamp: float, offsets: Sequence[int]) -> np.ndarray:
        out = np.empty(len(offsets), dtype=np.float64)
        for i, off in enumerate(offsets):
            out[i] = self.fracturns(start + off * tsamp)
        return out


class SpinPredictor:
    """Taylor spin model predictor from pulsar ephemeris parameters.

    phase(t) = F0*dt + F1*dt^2/2 + F2*dt^3/6 with dt = t - PEPOCH, the
    standard timing spin expansion.  This is the no-TEMPO fallback when only
    a .par file is given: the reference shells out to TEMPO/TEMPO2 to turn
    the ephemeris into a polyco (``Fold.C:229-267``); here the spin model is
    evaluated at the BARYCENTRIC arrival time via the analytic solar-system
    Roemer delay + observatory diurnal term (``timing/barycentre.py``) when
    the ephemeris carries RAJ/DECJ (cross-checked ~500x closer to TEMPO's
    Parkes vela.polyco apparent frequency than the raw topocentric model;
    residual ~7e-8 fractional).  Fine for folding, not for timing-grade
    absolute phase; supply a polyco/T2 predictor (-P) for that.
    """

    def __init__(self, f0: float, f1: float = 0.0, f2: float = 0.0,
                 pepoch: MJD | None = None, rphase: float = 0.0,
                 binary=None, ssb=None):
        self.f0 = float(f0)
        self.f1 = float(f1)
        self.f2 = float(f2)
        self.pepoch = pepoch or MJD(0, 0.0)
        self.rphase = float(rphase)
        #: optional orbital model (timing.binary.BTModel/ELL1Model): the spin
        #: model is evaluated at the emission time t - roemer_delay(t)
        self.binary = binary
        #: optional solar-system barycentric correction
        #: (timing.barycentre.SSBDelay): topocentric t maps to barycentric
        #: t + ssb.delay(t) before the spin model is evaluated — the role of
        #: TEMPO's barycentring that the reference gets via polyco
        #: generation (Fold.C:229-267)
        self.ssb = ssb

    @classmethod
    def from_ephemeris(cls, eph, barycentre: bool = True,
                       telescope: str | None = None) -> "SpinPredictor":
        from . import binary as binary_mod

        f2 = eph.get("F2")
        ssb = None
        if barycentre:
            raj, decj = eph.get("RAJ"), eph.get("DECJ")
            if raj and decj:
                from .barycentre import SSBDelay

                try:
                    ssb = SSBDelay.from_strings(str(raj), str(decj),
                                                telescope=telescope)
                except ValueError:
                    ssb = None
        return cls(eph.f0, eph.f1, float(f2) if f2 else 0.0, eph.pepoch,
                   binary=binary_mod.from_ephemeris(eph), ssb=ssb)

    def _emission(self, t: MJD) -> MJD:
        """Emission-frame time: apply the solar-system Roemer delay
        (topocentric -> barycentric), then subtract the orbital delay."""
        if self.ssb is not None:
            t = t + self.ssb.delay(t)
        if self.binary is None:
            return t
        return t - self.binary.roemer_delay(t)

    def phase(self, t: MJD) -> float:
        t = self._emission(t)
        dt = t - self.pepoch
        return self.rphase + dt * (self.f0 + dt * (self.f1 / 2.0 + dt * self.f2 / 6.0))

    def fracturns(self, t: MJD) -> float:
        t = self._emission(t)
        # split dt into integer-second + fractional parts to keep precision
        # (dt can be ~1e8 s; f0*dt overflows float64's 15 digits otherwise
        # only for ms pulsars far from PEPOCH — split keeps ~1e-6 turns)
        dsec = t - self.pepoch
        dint = math.floor(dsec)
        dfrac = dsec - dint
        # phase = f0*(dint+dfrac) + f1/2*(dint+dfrac)^2 + ...
        ph_int = self.f0 * dint
        ph_rest = (self.f0 * dfrac
                   + 0.5 * self.f1 * dsec * dsec
                   + self.f2 * dsec * dsec * dsec / 6.0
                   + self.rphase)
        frac = (ph_int - math.floor(ph_int)) + (ph_rest - math.floor(ph_rest))
        return frac - math.floor(frac)

    def frequency(self, t: MJD) -> float:
        dt = self._emission(t) - self.pepoch
        f = self.f0 + dt * (self.f1 + dt * self.f2 / 2.0)
        if self.ssb is not None:
            # apparent frequency includes the Earth's orbital Doppler
            # factor (1 + d ssb_delay/dt), v.n/c ~ 1e-4
            f *= 1.0 + self.ssb.delay_rate(t)
        if self.binary is not None:
            # apparent frequency includes the orbital Doppler factor
            # (1 - d delay/dt); central difference over 2 s resolves
            # ddelay/dt ~ 1e-4 to ~1e-10 precision in float64
            ddot = (self.binary.roemer_delay(t + 1.0)
                    - self.binary.roemer_delay(t - 1.0)) / 2.0
            f *= 1.0 - ddot
        return f

    def period(self, t: MJD) -> float:
        return 1.0 / self.frequency(t)

    def phase_anchors(self, start: MJD, tsamp: float, offsets: Sequence[int]) -> np.ndarray:
        out = np.empty(len(offsets), dtype=np.float64)
        for i, off in enumerate(offsets):
            out[i] = self.fracturns(start + off * tsamp)
        return out
