"""Phase-locked filterbank tests (reference: PhaseLockedFilterbank.C)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.ops.phase_locked import (
    PLFPlan, window_plan, extract_windows, plf_fold_block, plf_fold_numpy,
    phase_locked_fold, suggest_nchan,
)
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.timing.polyco import FixedPeriodPredictor


def test_window_plan_fixed_period():
    """Boundaries land every period/nbin seconds, cycling bins 0..nbin-1."""
    rate = 10000.0
    period = 0.1  # 1000 samples/turn
    nbin = 8  # 125 samples/bin
    t0 = MJD.from_mjd(55000.0)
    pred = FixedPeriodPredictor(period, reference_epoch=t0)
    plan = PLFPlan(nchan=16, nbin=nbin)
    starts, bins = window_plan(pred, t0, rate, 4000, plan)
    assert len(starts) > 20
    # consecutive boundaries are one bin apart in phase -> bins cycle
    assert np.all((np.diff(bins) % nbin) == 1)
    # spacing = period/nbin * rate = 125 samples
    d = np.diff(starts)
    assert np.all(np.abs(d - 125) <= 1)


def test_plf_fold_matches_numpy(rng):
    nwin, nchan_in, npol_in, nchan, nbin = 12, 2, 2, 16, 4
    windows = rng.normal(size=(nwin, nchan_in, npol_in, 2 * nchan)).astype(np.float32)
    bins = rng.integers(0, nbin, size=nwin).astype(np.int32)
    for npol_out in (1, 2, 4):
        plan = PLFPlan(nchan=nchan, nbin=nbin, npol_out=npol_out)
        s0 = np.zeros((nchan_in * nchan, npol_out, nbin), np.float32)
        h0 = np.zeros(nbin, np.float32)
        s_j, h_j = plf_fold_block(jnp.asarray(s0), jnp.asarray(h0),
                                  jnp.asarray(windows), jnp.asarray(bins), plan)
        s_n, h_n = plf_fold_numpy(s0, h0, windows, bins, plan)
        np.testing.assert_allclose(np.asarray(s_j), s_n, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(np.asarray(h_j), h_n)


def test_plf_fold_analytic(rng):
    nwin, nchan_in, npol_in, nchan, nbin = 6, 1, 2, 32, 4
    wr = rng.normal(size=(nwin, nchan_in, npol_in, nchan)).astype(np.float32)
    wi = rng.normal(size=(nwin, nchan_in, npol_in, nchan)).astype(np.float32)
    bins = rng.integers(0, nbin, size=nwin).astype(np.int32)
    plan = PLFPlan(nchan=nchan, nbin=nbin, npol_out=4, real_input=False)
    s0 = np.zeros((nchan_in * nchan, 4, nbin), np.float32)
    h0 = np.zeros(nbin, np.float32)
    s_j, h_j = plf_fold_block(jnp.asarray(s0), jnp.asarray(h0),
                              (jnp.asarray(wr), jnp.asarray(wi)),
                              jnp.asarray(bins), plan)
    s_n, h_n = plf_fold_numpy(s0, h0, (wr, wi), bins, plan)
    np.testing.assert_allclose(np.asarray(s_j), s_n, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(h_j), h_n)


def test_phase_locked_fold_end_to_end(tmp_path):
    """A tone at a known frequency shows up in the right output channel for
    every phase bin; hits are balanced across bins."""
    from dspsr_jax.observation import Observation, Signal
    from dspsr_jax.io.sources import RawFileSource

    rate = 8000.0
    nsamp = 60000
    t = np.arange(nsamp) / rate
    tone = np.cos(2 * np.pi * 1000.0 * t) * 20  # 1 kHz in a 4 kHz band
    raw2 = np.stack([tone, tone], axis=1).reshape(-1)  # 2 pol interleaved
    path = tmp_path / "tone.raw"
    (np.clip(np.round(raw2), -127, 127).astype(np.int64) + 128).astype(
        np.uint8).tofile(path)

    obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                      centre_frequency=1000.0, bandwidth=4.0 / 1000,
                      rate=rate, start_time=MJD.from_mjd(55000.0),
                      state=Signal.NYQUIST, source="TONE", ndat=nsamp)
    src = RawFileSource(str(path), obs)
    pred = FixedPeriodPredictor(0.25, reference_epoch=obs.start_time)
    res = phase_locked_fold(src, pred, nbin=8, nchan=16,
                            block_samples=16384)
    assert res.hits.sum() > 0
    # 1 kHz tone in [0,4kHz) band, nchan=16 -> channel 4
    prof = res.normalized()
    assert np.all(prof.argmax(axis=0)[0] == 4)
    # bins are uniformly visited for a fixed period
    assert res.hits.max() - res.hits.min() <= 2


def test_suggest_nchan():
    assert suggest_nchan(1.0, 8192.0, 8) == 1024
    assert suggest_nchan(0.1, 10000.0, 8) == 64
