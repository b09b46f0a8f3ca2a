"""Tests for the fold kernel (one-hot matmul formulation vs numpy reference)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.timing.mjd import MJD
from dspsr_jax.timing.polyco import FixedPeriodPredictor
from dspsr_jax.ops.fold import (
    FoldPlan,
    choose_nbin,
    compute_anchors,
    compute_bins,
    fold_block,
    fold_block_numpy,
)


class TestChooseNbin:
    def test_vela_defaults(self):
        # Vela: P=89.3ms, detected rate e.g. 1 MHz -> cap at 1024
        assert choose_nbin(0.0893, 1e-6) == 1024

    def test_slow_sampling(self):
        # period 10ms, tsamp 1ms: floor(10/1.2) = 8 bins
        assert choose_nbin(0.010, 0.001) == 8

    def test_requested_wins(self):
        assert choose_nbin(0.010, 0.001, requested=333) == 333

    def test_minimum(self):
        assert choose_nbin(0.001, 0.01) == 2


class TestAnchors:
    def test_fixed_period_anchors(self):
        pred = FixedPeriodPredictor(0.1, MJD(55000, 0.0))
        start = MJD(55000, 10.0)
        tsamp = 1e-3
        phi0, dphi = compute_anchors(pred, start, tsamp, 4096, 1024)
        assert phi0.shape == (4,) and dphi.shape == (4,)
        np.testing.assert_allclose(dphi, 0.01, rtol=1e-6)
        # anchor spacing: 1024 samples * 0.01 turns/sample = 10.24 turns
        np.testing.assert_allclose((phi0[1] - phi0[0]) % 1.0, 0.24, atol=1e-5)

    def test_bins_monotone_within_turn(self):
        phi0 = np.array([0.0], np.float32)
        dphi = np.array([1.0 / 64], np.float32)
        bins = np.asarray(compute_bins(jnp.asarray(phi0), jnp.asarray(dphi), 64, nbin=16))
        # 64 samples cover exactly one turn in 16 bins: 4 samples per bin
        np.testing.assert_array_equal(bins, np.repeat(np.arange(16), 4))


class TestFoldBlock:
    @pytest.mark.parametrize("nchan,npol", [(1, 1), (2, 2), (3, 4)])
    def test_matches_numpy_reference(self, rng, nchan, npol):
        plan = FoldPlan(nbin=32, seg_len=128)
        nseg, ndat = 4, 4 * 128
        x = rng.standard_normal((nchan, npol, ndat)).astype(np.float32)
        w = (rng.uniform(size=(nchan, ndat)) > 0.1).astype(np.float32)
        # random phase trajectory, away from exact bin boundaries
        phi0 = (rng.uniform(size=nseg) + 0.001).astype(np.float32)
        dphi = np.full(nseg, 0.003171, np.float32)

        p0 = np.zeros((nchan, npol, plan.nbin), np.float32)
        h0 = np.zeros((nchan, plan.nbin), np.float32)
        prof_j, hits_j = fold_block(
            jnp.asarray(p0), jnp.asarray(h0), jnp.asarray(x), jnp.asarray(w),
            jnp.asarray(phi0), jnp.asarray(dphi), plan)
        prof_n, hits_n = fold_block_numpy(p0, h0, x, w, phi0, dphi, plan)

        np.testing.assert_allclose(np.asarray(hits_j), hits_n, atol=1e-4)
        np.testing.assert_allclose(np.asarray(prof_j), prof_n, rtol=1e-5, atol=1e-4)

    def test_accumulates_across_blocks(self, rng):
        """Folding two blocks sequentially == folding their concatenation."""
        plan = FoldPlan(nbin=16, seg_len=64)
        nchan, npol = 1, 2
        x = rng.standard_normal((nchan, npol, 256)).astype(np.float32)
        w = np.ones((nchan, 256), np.float32)
        dphi = np.full(4, 0.0137, np.float32)
        phi0 = ((np.arange(4) * 64 * 0.0137) % 1.0).astype(np.float32)

        p0 = jnp.zeros((nchan, npol, plan.nbin))
        h0 = jnp.zeros((nchan, plan.nbin))
        p_all, h_all = fold_block(
            p0, h0, jnp.asarray(x), jnp.asarray(w),
            jnp.asarray(phi0), jnp.asarray(dphi), plan)

        p_acc = jnp.zeros((nchan, npol, plan.nbin))
        h_acc = jnp.zeros((nchan, plan.nbin))
        for b in range(2):
            sl = slice(b * 128, (b + 1) * 128)
            p_acc, h_acc = fold_block(
                p_acc, h_acc, jnp.asarray(x[:, :, sl]), jnp.asarray(w[:, sl]),
                jnp.asarray(phi0[b * 2 : b * 2 + 2]),
                jnp.asarray(dphi[b * 2 : b * 2 + 2]), plan)
        np.testing.assert_allclose(np.asarray(p_all), np.asarray(p_acc), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(h_all), np.asarray(h_acc), rtol=1e-6)

    def test_pulse_lands_in_right_bin(self):
        """A periodic impulse train folds into a single phase bin."""
        plan = FoldPlan(nbin=16, seg_len=256)
        period_samples = 64  # exactly 4 samples per bin at nbin=16... period=64
        ndat = 1024
        x = np.zeros((1, 1, ndat), np.float32)
        x[0, 0, ::period_samples] = 1.0  # impulse at phase 0 of every turn
        w = np.ones((1, ndat), np.float32)
        dphi = np.full(4, 1.0 / period_samples, np.float32)
        phi0 = ((np.arange(4) * 256) / period_samples % 1.0).astype(np.float32)
        p0 = jnp.zeros((1, 1, plan.nbin))
        h0 = jnp.zeros((1, plan.nbin))
        prof, hits = fold_block(p0, h0, jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(phi0), jnp.asarray(dphi), plan)
        prof = np.asarray(prof)[0, 0]
        assert prof[0] == 16.0  # 1024/64 impulses all in bin 0
        assert prof[1:].sum() == 0
        # hits uniform: 1024/16 bins = 64 samples per bin
        np.testing.assert_allclose(np.asarray(hits)[0], 64.0)

    def test_weights_mask_samples(self, rng):
        plan = FoldPlan(nbin=8, seg_len=64)
        x = np.ones((1, 1, 64), np.float32)
        w = np.zeros((1, 64), np.float32)
        w[0, :32] = 1.0
        phi0 = np.array([0.0], np.float32)
        dphi = np.array([1.0 / 64], np.float32)
        prof, hits = fold_block(
            jnp.zeros((1, 1, 8)), jnp.zeros((1, 8)),
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(phi0), jnp.asarray(dphi), plan)
        # first half of the turn (bins 0..3) weighted 1, rest 0
        np.testing.assert_allclose(np.asarray(hits)[0], [8, 8, 8, 8, 0, 0, 0, 0])
        np.testing.assert_allclose(np.asarray(prof)[0, 0], [8, 8, 8, 8, 0, 0, 0, 0])
