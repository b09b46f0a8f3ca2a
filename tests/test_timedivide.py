"""Sample-exact TimeDivide semantics (reference Signal/Pulsar/TimeDivide.C).

These tests pin the HOST-side division bookkeeping: UTC-second alignment
of integer -L, sample-quantized boundaries, turn divisions anchored at the
reference-phase crossing, the fractional-pulses (-y) convention, and the
block segmentation that drives the per-sample fold bounds.
"""

import math

import numpy as np
import pytest

from dspsr_jax.timing.mjd import MJD
from dspsr_jax.timing.polyco import FixedPeriodPredictor
from dspsr_jax.timing.timedivide import TimeDivide, iphase

RATE = 1e6  # 1 Msample/s output domain


class TestSecondsMode:
    def test_integer_seconds_align_to_utc(self):
        """-L 10 starting at 04321.7 s of day: the division reference
        rounds DOWN to 4320 s (a whole multiple of 10 in the UTC day,
        TimeDivide.C:70-81), so the first boundary inside the data is at
        4330 s, i.e. 8.3 s in."""
        start = MJD(55000, 4321.7)
        td = TimeDivide(RATE, start, seconds=10.0)
        assert td.ref_time == MJD(55000, 4320.0)
        assert td.division_of(0) == 0
        b1 = td.boundary_sample(1)
        assert b1 == round(8.3 * RATE)
        assert td.division_of(b1 - 1) == 0
        assert td.division_of(b1) == 1

    def test_non_integer_seconds_reference_is_start(self):
        start = MJD(55000, 4321.7)
        td = TimeDivide(RATE, start, seconds=0.25)
        assert td.ref_time == start
        assert td.boundary_sample(1) == round(0.25 * RATE)
        assert td.boundary_sample(7) == round(7 * 0.25 * RATE)

    def test_reference_epoch_override(self):
        """-Lepoch pins the division grid (TimeDivide.C:60-67)."""
        start = MJD(55000, 4321.7)
        lep = MJD(55000, 4321.0)
        td = TimeDivide(RATE, start, seconds=10.0, reference_epoch=lep)
        # boundary 1 is at Lepoch + 10 s = 9.3 s into the data
        assert td.boundary_sample(1) == round(9.3 * RATE)

    def test_segments_split_at_exact_samples(self):
        start = MJD(55000, 4321.7)
        td = TimeDivide(RATE, start, seconds=10.0)
        b1 = td.boundary_sample(1)
        # block of 1e6 samples straddling the boundary
        off = b1 - 100
        segs = td.segments(off, 1000)
        assert segs == [(0, 100, 0), (100, 1000, 1)]
        # whole-block inside one division
        assert td.segments(0, 1000) == [(0, 1000, 0)]
        # sum of spans always covers the block
        segs = td.segments(0, 25_000_000)  # spans 3 boundaries
        assert segs[0][0] == 0 and segs[-1][1] == 25_000_000
        assert [s[2] for s in segs] == [0, 1, 2]
        for (a, b, _), (c, d, _) in zip(segs, segs[1:]):
            assert b == c

    def test_integration_lengths_exact(self):
        """Interior divisions hold exactly round(L*rate) samples when L*rate
        is integral."""
        start = MJD(55000, 4321.7)
        td = TimeDivide(RATE, start, seconds=10.0)
        for k in range(1, 5):
            n = td.boundary_sample(k + 1) - td.boundary_sample(k)
            assert n == int(10.0 * RATE)


class TestTurnsMode:
    PERIOD = 0.0052  # 5.2 ms — many pulses per block

    def _pred(self, epoch):
        return FixedPeriodPredictor(self.PERIOD, epoch)

    def test_head_discarded_without_fractional(self):
        """Without -y, data before the first reference-phase crossing is
        division -1 (discarded; TimeDivide.C:425-429 rounds the start
        phase UP)."""
        epoch = MJD(55000, 1000.0)
        start = epoch + 0.5 * self.PERIOD  # mid-pulse
        td = TimeDivide(RATE, start, turns=1, predictor=self._pred(epoch))
        assert td.division_of(0) == -1
        b0 = td.boundary_sample(0)
        assert b0 == round(0.5 * self.PERIOD * RATE)
        segs = td.segments(0, round(2.2 * self.PERIOD * RATE))
        assert segs[0][2] == -1 and segs[0][0] == 0
        assert [s[2] for s in segs[1:]] == [0, 1]

    def test_fractional_pulses_keeps_partial_head(self):
        """-y: the start phase rounds DOWN to the current turn's
        reference-phase crossing, so the partial first pulse is kept."""
        epoch = MJD(55000, 1000.0)
        start = epoch + 0.5 * self.PERIOD
        td = TimeDivide(RATE, start, turns=1, predictor=self._pred(epoch),
                        fractional_pulses=True)
        assert td.division_of(0) == 0
        # first boundary inside the data is the NEXT crossing
        assert td.boundary_sample(1) == round(0.5 * self.PERIOD * RATE)

    def test_single_pulse_boundaries_every_period(self):
        epoch = MJD(55000, 1000.0)
        td = TimeDivide(RATE, epoch, turns=1, predictor=self._pred(epoch))
        for k in range(1, 6):
            n = td.boundary_sample(k + 1) - td.boundary_sample(k)
            assert abs(n - self.PERIOD * RATE) <= 1

    def test_reference_phase_offsets_boundaries(self):
        """-p 0.25: divisions begin at phase 0.25 of each pulse."""
        epoch = MJD(55000, 1000.0)
        td = TimeDivide(RATE, epoch, turns=1, predictor=self._pred(epoch),
                        reference_phase=0.25)
        assert td.boundary_sample(0) == round(0.25 * self.PERIOD * RATE)

    def test_multi_turn_divisions(self):
        epoch = MJD(55000, 1000.0)
        td = TimeDivide(RATE, epoch, turns=4, predictor=self._pred(epoch))
        n = td.boundary_sample(1) - td.boundary_sample(0)
        assert abs(n - 4 * self.PERIOD * RATE) <= 1

    def test_subturn_divisions(self):
        """turns < 1 (PhaseLockedFilterbank divider): boundaries every
        quarter turn from the next multiple of 0.25."""
        epoch = MJD(55000, 1000.0)
        start = epoch + 0.3 * self.PERIOD
        td = TimeDivide(RATE, start, turns=0.25,
                        predictor=self._pred(epoch))
        # next multiple of 0.25 after phase 0.3 is 0.5 -> 0.2 turns ahead
        assert td.boundary_sample(0) == round(0.2 * self.PERIOD * RATE)
        n = td.boundary_sample(2) - td.boundary_sample(1)
        assert abs(n - 0.25 * self.PERIOD * RATE) <= 1


class TestIphase:
    def test_newton_inverts_constant_period(self):
        epoch = MJD(55000, 1000.0)
        pred = FixedPeriodPredictor(0.0052, epoch)
        t = iphase(pred, 1234.0, epoch)
        assert abs(pred.phase(t) - 1234.0) < 1e-9

    def test_newton_inverts_polyco(self, vela_polyco):
        t0 = vela_polyco.blocks[0].tmid if hasattr(vela_polyco, "blocks") \
            else None
        if t0 is None:
            pytest.skip("polyco block structure differs")
        target = vela_polyco.phase(t0) + 100.0
        t = iphase(vela_polyco, target, t0)
        assert abs(vela_polyco.phase(t) - target) < 1e-6
