"""Sample-exact sub-integration boundary bookkeeping.

Host-side equivalent of the reference ``dsp::TimeDivide``
(``Signal/Pulsar/TimeDivide.C``), driving the pipelines' per-block fold
bounds the way ``SubFold::set_limits`` drives ``Fold::idat_start`` /
``ndat_fold`` (``Signal/Pulsar/SubFold.C:189-195``): each block of output
samples is split at EXACT sample indices across division boundaries, and
the device step folds each span with a per-sample bounds mask
(the device analogue of folding the block once per division).

Reference conventions reproduced:

- ``set_start_time`` (``TimeDivide.C:48-81``): the division reference is
  the explicit reference epoch (``-Lepoch``) when given; otherwise, for an
  INTEGER number of division seconds, the observation start rounded DOWN
  to a whole multiple of the division length within the UTC day
  (``MJD(intday, (secs // L) * L, 0)``) — so ``-L 10`` archives from any
  two runs share UTC-aligned sub-integration grids; otherwise the start
  time itself.
- Turn divisions (``set_boundaries``, ``TimeDivide.C:354-436``): the
  first division starts at the ``reference_phase`` crossing.  Without
  ``fractional_pulses`` the start phase rounds UP to the next crossing
  (data before it is DISCARDED — division index -1 here); with
  ``fractional_pulses`` (-y) the crossing of the current turn is used, so
  a partial first pulse is kept.  Sub-turn divisions (turns < 1, the
  PhaseLockedFilterbank divider) advance to the next multiple of
  ``division_turns`` from ``reference_phase``.
- Boundary quantization (``set_boundaries(MJD,MJD)``,
  ``TimeDivide.C:503-522``): each boundary maps to the nearest output
  sample, ``lrint((boundary - start) * rate)`` — divisions own whole
  samples, and per-division sample counts are exact.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .mjd import MJD


def iphase(predictor, target_turns: float, guess: MJD,
           tol_seconds: float = 1e-10, max_iter: int = 20) -> MJD:
    """Invert ``predictor.phase``: the MJD at which the absolute phase
    equals ``target_turns`` (reference ``Pulsar::Predictor::iphase``).

    Newton iteration on ``phase(t) - target`` using the predictor's
    instantaneous frequency; a constant-period predictor converges in one
    step, polynomial predictors in a few.
    """
    t = guess
    for _ in range(max_iter):
        err = predictor.phase(t) - target_turns
        f = predictor.frequency(t)
        if f <= 0:
            raise ValueError("predictor frequency must be positive")
        dt = err / f
        t = t - dt
        if abs(dt) < tol_seconds:
            return t
    return t


class TimeDivide:
    """Maps global output-sample indices to division indices, with
    sample-exact boundaries.

    Args:
      rate: output-domain sampling rate (samples/second).
      start_time: MJD of global output sample 0 of the run (seek applied).
      seconds: division length in seconds (-L); 0 = off.
      turns: division length in pulse turns (--turns / -s); 0 = off.
      predictor: folding predictor (required for turn divisions).
      reference_phase: pulse phase of the turn-division boundaries (-p).
      reference_epoch: explicit division reference MJD (-Lepoch).
      fractional_pulses: keep the partial first pulse (-y).
      integer_boundaries: align integer -L to UTC-second multiples of the
        day (reference ``integer_division_seconds_boundaries``).
    """

    def __init__(self, rate: float, start_time: MJD, seconds: float = 0.0,
                 turns: float = 0.0, predictor=None,
                 reference_phase: float = 0.0,
                 reference_epoch: Optional[MJD] = None,
                 fractional_pulses: bool = False,
                 integer_boundaries: bool = True):
        if (seconds > 0) == (turns > 0):
            raise ValueError("exactly one of seconds/turns must be set")
        if turns > 0 and predictor is None:
            raise ValueError("turn divisions need a folding predictor")
        self.rate = float(rate)
        self.start_time = start_time
        self.seconds = float(seconds)
        self.turns = float(turns)
        self.predictor = predictor
        self.reference_phase = reference_phase - math.floor(reference_phase)
        self.fractional_pulses = bool(fractional_pulses)
        self._bcache: dict = {}

        if self.seconds > 0:
            if reference_epoch is not None:
                self.ref_time = reference_epoch
            elif integer_boundaries and self.seconds == int(self.seconds) \
                    and int(self.seconds) > 0:
                L = int(self.seconds)
                secs = int(start_time.secs)
                self.ref_time = MJD(start_time.days, float((secs // L) * L))
            else:
                self.ref_time = start_time
        else:
            ref0 = reference_epoch if reference_epoch is not None \
                else start_time
            p = predictor.phase(ref0)
            int_turns = math.floor(p)
            frac = p - int_turns
            if self.turns < 1.0:
                # next multiple of turns from reference_phase
                # (TimeDivide.C:371-424)
                x_minus_r = frac - self.reference_phase
                if frac < self.reference_phase:
                    x_minus_r += 1.0
                    int_turns -= 1
                n = math.ceil(x_minus_r / self.turns)
                self.start_phase = (int_turns + self.reference_phase
                                    + n * self.turns)
            else:
                if not self.fractional_pulses and frac > self.reference_phase:
                    int_turns += 1
                self.start_phase = int_turns + self.reference_phase
            self._t_ref0 = ref0

    # ---- boundaries ----

    def boundary_time(self, k: int) -> MJD:
        """Un-quantized MJD of the start of division ``k``."""
        if self.seconds > 0:
            return self.ref_time + k * self.seconds
        target = self.start_phase + k * self.turns
        guess = self._t_ref0 + (
            (target - self.predictor.phase(self._t_ref0))
            / self.predictor.frequency(self._t_ref0))
        return iphase(self.predictor, target, guess)

    def boundary_sample(self, k: int) -> int:
        """Global output-sample index of the start of division ``k``
        (may be negative: the division began before the data)."""
        b = self._bcache.get(k)
        if b is None:
            b = int(round((self.boundary_time(k) - self.start_time)
                          * self.rate))
            self._bcache[k] = b
        return b

    def division_of(self, sample: int) -> int:
        """Division index owning the given global output sample; -1 when
        the sample precedes division 0 (turn mode without -y: discard)."""
        if self.seconds > 0:
            t = self.start_time + sample / self.rate
            k = int(math.floor((t - self.ref_time) / self.seconds))
        else:
            t = self.start_time + sample / self.rate
            k = int(math.floor(
                (self.predictor.phase(t) - self.start_phase) / self.turns))
        # fix up against the sample-quantized boundaries
        while k >= 0 and self.boundary_sample(k) > sample:
            k -= 1
        while self.boundary_sample(k + 1) <= sample:
            k += 1
        return k if k >= 0 else -1

    def segments(self, off: int, nsamp: int) \
            -> List[Tuple[int, int, int]]:
        """Split block output samples [off, off+nsamp) at division
        boundaries.

        Returns ordered ``(lo, hi, division)`` spans with lo/hi RELATIVE
        to the block (0 <= lo < hi <= nsamp); ``division == -1`` marks
        data before the first division (to be discarded, reference
        ``TimeDivide::set_bounds`` idat_start skip).
        """
        segs = []
        j = off
        k = self.division_of(off)
        while j < off + nsamp:
            nxt = self.boundary_sample(k + 1) if k >= 0 \
                else self.boundary_sample(0)
            if nxt <= j:  # zero-length guard (pathological predictor)
                nxt = off + nsamp
            hi = min(nxt, off + nsamp)
            segs.append((j - off, hi - off, k))
            j = hi
            if j == nxt:
                k += 1
        return segs

    def epoch_of(self, first_folded_sample: int) -> MJD:
        """MJD of a division's first folded sample (the sub-integration
        epoch; for a division that began before the data this is the data
        start, matching the reference's ``max(lower, input_start)``)."""
        return self.start_time + first_folded_sample / self.rate
