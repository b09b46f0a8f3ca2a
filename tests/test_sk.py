"""Spectral-kurtosis RFI excision tests (PearsonIV/SKLimits + masking)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.utils.stats import PearsonIV, sk_limits
from dspsr_jax.ops.spectral_kurtosis import SKPlan, sk_estimate, sk_mask, expand_mask
from dspsr_jax.models.load_to_fold import FoldConfig, load_to_fold
from test_pipeline import synth_pulsar_dada, PERIOD, DM, PULSE_PHASE, RATE


class TestPearsonIV:
    def test_moments_match_reference_formulas(self):
        # PearsonIV.C:28-60 for M=128
        p = PearsonIV(128)
        M = 128.0
        assert p.mu2 == pytest.approx(4 * M * M / ((M - 1) * (M + 2) * (M + 3)))
        assert p.m > 0.5
        assert np.isfinite(p.v) and np.isfinite(p.a) and np.isfinite(p.logk)

    def test_pdf_normalized(self):
        p = PearsonIV(128)
        xs = np.linspace(0.01, 5.0, 20001)
        total = np.trapezoid(p.pdf(xs), xs)
        assert abs(total - 1.0) < 1e-3

    def test_pdf_mean_is_one(self):
        p = PearsonIV(64)
        xs = np.linspace(0.01, 6.0, 40001)
        mean = np.trapezoid(xs * p.pdf(xs), xs)
        assert abs(mean - 1.0) < 1e-3


class TestSKLimits:
    def test_limits_bracket_one(self):
        t = sk_limits(128, 3)
        assert 0.5 < t.lower < 1.0 < t.upper < 2.0

    def test_gaussian_limit_large_m(self):
        t = sk_limits(65536, 3)
        s = np.sqrt(4.0 / 65536)
        assert t.lower == pytest.approx(1 - 3 * s)
        assert t.upper == pytest.approx(1 + 3 * s)

    def test_asymmetry(self):
        # SK distribution is right-skewed for small M: upper tail further out
        t = sk_limits(128, 3)
        assert (t.upper - 1.0) > (1.0 - t.lower)

    def test_tail_probability(self):
        """Thresholds actually cut ~the right tail mass on simulated data."""
        rng = np.random.default_rng(5)
        M = 128
        t = sk_limits(M, 3)
        # complex Gaussian power: exponential distribution
        p = rng.exponential(size=(20000, M))
        s1 = p.sum(1)
        s2 = (p ** 2).sum(1)
        sk = (M + 1) / (M - 1) * (M * s2 / s1 ** 2 - 1)
        frac_out = np.mean((sk < t.lower) | (sk > t.upper))
        expect = 1 - np.erf(3 / np.sqrt(2)) if hasattr(np, "erf") else 0.0027
        assert 0.0005 < frac_out < 0.01, frac_out


class TestSKMask:
    def test_clean_noise_mostly_kept(self, rng):
        M, nblk, nchan = 128, 32, 4
        power = rng.exponential(size=(nchan, 1, nblk * M)).astype(np.float32)
        plan = SKPlan(M, 3, detect_tscr=False, detect_fscr=False)
        w = np.asarray(sk_mask(jnp.asarray(power), plan, nblk))
        assert w.mean() > 0.95

    def test_interference_zapped(self, rng):
        M, nblk, nchan = 128, 16, 4
        power = rng.exponential(size=(nchan, 1, nblk * M)).astype(np.float32)
        # impulsive RFI in channel 2, block 5: a few huge samples
        power[2, 0, 5 * M : 5 * M + 4] += 500.0
        plan = SKPlan(M, 3, detect_tscr=False, detect_fscr=False)
        w = np.asarray(sk_mask(jnp.asarray(power), plan, nblk))
        assert w[2, 5] == 0.0
        assert w[1, 5] == 1.0

    def test_tscr_catches_persistent(self, rng):
        M, nblk, nchan = 128, 16, 4
        power = rng.exponential(size=(nchan, 1, nblk * M)).astype(np.float32)
        # persistent sinusoidal modulation in channel 1 (non-Gaussian duty)
        power[1, 0] = (rng.exponential(size=nblk * M) *
                       (1 + 5 * (np.arange(nblk * M) % 7 == 0))).astype(np.float32)
        plan = SKPlan(M, 3, detect_cell=False, detect_fscr=False)
        w = np.asarray(sk_mask(jnp.asarray(power), plan, nblk))
        assert w[1].max() == 0.0
        assert w[0].min() == 1.0

    def test_expand(self):
        w = jnp.asarray(np.array([[1.0, 0.0]], np.float32))
        e = np.asarray(expand_mask(w, 3))
        np.testing.assert_array_equal(e, [[1, 1, 1, 0, 0, 0]])


class TestPipelineIntegration:
    def test_sk_zaps_injected_rfi(self, tmp_path):
        """Inject a saturating RFI stretch into noise; SK zaps it."""
        path = str(tmp_path / "rfi.dada")
        synth_pulsar_dada(path, nsec=0.2, seed=3, amp=0.0)  # pure noise
        # overwrite a stretch with a strong burst of a narrowband tone at
        # +1/8 of the band (inside channel 2 of 4): intermittent -> cell SK
        nrfi = 40960  # complex samples
        t = np.arange(nrfi)
        tone = 60.0 * np.cos(2 * np.pi * 0.125 * t)
        toneq = 60.0 * np.sin(2 * np.pi * 0.125 * t)
        # burst on/off every 64 samples (impulsive within SK cells)
        gate = (t // 64) % 2
        tfp = np.zeros((nrfi, 2, 2))
        tfp[:, :, 0] = (tone * gate)[:, None]
        tfp[:, :, 1] = (toneq * gate)[:, None]
        q = np.clip(np.round(tfp + 127.0), 0, 255).astype(np.uint8)
        with open(path, "r+b") as f:
            f.seek(4096 + 4 * (int(0.2 * RATE) // 3))
            f.write(q.tobytes())

        base = dict(folding_period=PERIOD, dispersion_measure=DM,
                    nchan=4, block_parts=2)
        res_no = load_to_fold(path, FoldConfig(**base))
        # tscr disabled: on heavily quantized synthetic data the whole-block
        # SK threshold (Gaussian limit at huge M) trips on quantization bias,
        # as it does in the reference (same SKLimits formula) — the
        # reference's --skz_no_tscr escape hatch exists for exactly this
        res_sk = load_to_fold(path, FoldConfig(**base, sk_enable=True,
                                               sk_no_tscr=True))
        # SK must drop the RFI samples
        assert res_sk.hits.sum() < res_no.hits.sum()
        # the tone inflates channel 2's folded power; SK removes that energy
        ch = 2
        avg_no = res_no.profiles[0, ch].sum() / max(res_no.hits[0, ch].sum(), 1)
        avg_sk = res_sk.profiles[0, ch].sum() / max(res_sk.hits[0, ch].sum(), 1)
        assert avg_sk < 0.5 * avg_no, (avg_sk, avg_no)

    def test_noskz_too_folds_unzapped_fork(self, tmp_path):
        """-noskz_too: the pre-SK stream folds into an extra 'nosk'
        result (reference presk_fold fork + '.nosk' Archiver,
        LoadToFold1.C:458-501): it matches the SK-free run exactly, while
        the primary result is the SK-zapped fold."""
        path = str(tmp_path / "nosk.dada")
        synth_pulsar_dada(path, nsec=0.2, seed=3, amp=0.0)
        nrfi = 40960
        t = np.arange(nrfi)
        gate = (t // 64) % 2
        tfp = np.zeros((nrfi, 2, 2))
        tfp[:, :, 0] = (60.0 * np.cos(2 * np.pi * 0.125 * t) * gate)[:, None]
        tfp[:, :, 1] = (60.0 * np.sin(2 * np.pi * 0.125 * t) * gate)[:, None]
        q = np.clip(np.round(tfp + 127.0), 0, 255).astype(np.uint8)
        with open(path, "r+b") as f:
            f.seek(4096 + 4 * (int(0.2 * RATE) // 3))
            f.write(q.tobytes())

        base = dict(folding_period=PERIOD, dispersion_measure=DM,
                    nchan=4, block_parts=2)
        res = load_to_fold(path, FoldConfig(**base, sk_enable=True,
                                            sk_no_tscr=True,
                                            sk_also_unzapped=True))
        assert res.extra_sources and res.extra_sources[0].label == "nosk"
        nosk = res.extra_sources[0]
        plain = load_to_fold(path, FoldConfig(**base))
        # un-zapped fork == the SK-free run, bit-for-bit bookkeeping
        np.testing.assert_allclose(nosk.hits, plain.hits, rtol=0, atol=0)
        np.testing.assert_allclose(nosk.profiles, plain.profiles,
                                   rtol=1e-6, atol=1e-3)
        # primary (zapped) dropped the RFI samples the fork kept
        assert res.hits.sum() < nosk.hits.sum()

    def test_sk_keeps_weak_pulsar(self, tmp_path):
        """A weak pulsar survives SK excision (pulse not zapped away)."""
        path = str(tmp_path / "weak.dada")
        synth_pulsar_dada(path, nsec=0.3, seed=4, amp=1.0)
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, sk_enable=True,
                         sk_no_tscr=True)
        res = load_to_fold(path, cfg)
        base = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                          nchan=4, block_parts=2)
        res_no = load_to_fold(path, base)
        # the bulk of the data is retained (SK also clips pulse-modulated
        # cells, so retention is below the clean-noise ~99%)
        assert res.hits.sum() > 0.6 * res_no.hits.sum()
        prof = res.dedispersed()[0].sum(0)[0]
        peak = prof.argmax() / res.nbin
        assert abs(peak - PULSE_PHASE) < 0.05, peak


class TestRFIFilter:
    def test_median_filter(self):
        from dspsr_jax.ops.rfifilter import median_filter_freq
        x = jnp.asarray(np.array([1., 1, 1, 50, 1, 1, 1, 1], np.float32))
        m = np.asarray(median_filter_freq(x, 3))
        np.testing.assert_array_equal(m, 1.0)

    def test_tone_zapped_in_pipeline(self, tmp_path, rng):
        """A persistent narrowband tone is removed by the bandpass filter."""
        path = str(tmp_path / "tone.dada")
        synth_pulsar_dada(path, nsec=0.1, seed=6, amp=0.0)
        # add a persistent strong tone at +1/8 band to the whole file
        import os
        from dspsr_jax.io.sources import open_source
        src = open_source(path)
        n = src.total_samples
        t = np.arange(n)
        tone = 40 * np.exp(2j * np.pi * 0.125 * t)
        add = np.zeros((n, 2, 2))
        add[:, :, 0] = tone.real[:, None]
        add[:, :, 1] = tone.imag[:, None]
        raw = src.read_samples(0, n).reshape(n, 2, 2).astype(np.float64)
        q = np.clip(np.round(raw + add), 0, 255).astype(np.uint8)
        with open(path, "r+b") as f:
            f.seek(4096)
            f.write(q.tobytes())

        base = dict(folding_period=PERIOD, dispersion_measure=DM,
                    nchan=4, block_parts=2)
        res_no = load_to_fold(path, FoldConfig(**base))
        res_rf = load_to_fold(path, FoldConfig(**base, rfi_filter=True))
        # tone sits in channel 2; its folded power drops with the filter
        ch = 2
        p_no = res_no.normalized()[0, ch, 0].mean()
        p_rf = res_rf.normalized()[0, ch, 0].mean()
        other_no = res_no.normalized()[0, 0, 0].mean()
        other_rf = res_rf.normalized()[0, 0, 0].mean()
        assert p_rf < 0.5 * p_no, (p_rf, p_no)
        # clean channel mostly unaffected
        assert other_rf > 0.8 * other_no
