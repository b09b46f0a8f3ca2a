"""Tests for apodization windows, polyphase filterbank, fourth moments op."""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.ops.apodization import WindowType, build_window
from dspsr_jax.ops.polyphase import (
    PolyphasePlan, polyphase_filterbank_block, prototype_lowpass,
)
from dspsr_jax.ops.fourth_moment import fourth_moment, PAIRS
from scutil import sc_of, c_of


class TestApodization:
    def test_hanning(self):
        w = build_window(WindowType.HANNING, 64)
        assert w[0] == pytest.approx(0.0, abs=1e-6)
        assert w[32] == pytest.approx(1.0, abs=1e-2)
        np.testing.assert_allclose(w, w[::-1], atol=1e-6)

    def test_welch_parzen_positive(self):
        for k in (WindowType.WELCH, WindowType.PARZEN):
            w = build_window(k, 33)
            assert w.min() >= 0 and w.max() <= 1.0 + 1e-6

    def test_tukey_flat_top(self):
        w = build_window(WindowType.TUKEY, 64, transition=8)
        np.testing.assert_allclose(w[8:56], 1.0)

    def test_none(self):
        np.testing.assert_array_equal(build_window(WindowType.NONE, 16), 1.0)


class TestPolyphase:
    def test_tone_lands_in_channel(self):
        nc, taps = 16, 8
        plan = PolyphasePlan(real_input=False, nchan_subband=nc, ntaps=taps)
        h = jnp.asarray(prototype_lowpass(nc, taps))
        npart = 64
        ndat = plan.block_ndat(npart)
        for c in [1, 7, 12]:
            f = -0.5 + (c + 0.5) / nc
            x = np.exp(2j * np.pi * f * np.arange(ndat)).astype(np.complex64)
            y = c_of(polyphase_filterbank_block(
                sc_of(x[None, None, :]), h, plan, npart))
            assert y.shape == (nc, 1, npart)
            power = np.abs(y[:, 0]).mean(axis=1) ** 2
            assert power.argmax() == c, (c, power.argmax())

    def test_channel_isolation_beats_fft(self):
        """PFB leakage into a neighbouring channel is far below the plain
        critically-sampled FFT filterbank's (the PFB's raison d'etre)."""
        from dspsr_jax.ops.filterbank import FilterbankPlan, filterbank_block

        nc = 16
        taps = 12
        pplan = PolyphasePlan(False, nc, taps)
        h = jnp.asarray(prototype_lowpass(nc, taps))
        fplan = FilterbankPlan(False, nc, 1)

        npart = 256
        ndat = pplan.block_ndat(npart)
        # tone halfway between channels 5 and 6 edges... offset 0.25 channel
        f = -0.5 + (5 + 0.75) / nc
        x = np.exp(2j * np.pi * f * np.arange(ndat)).astype(np.complex64)

        yp = c_of(polyphase_filterbank_block(sc_of(x[None, None, :]), h, pplan, npart))
        nf = fplan.npart(ndat)
        yf = c_of(filterbank_block(sc_of(x[None, None, :]), fplan, nf))

        def leakage(y):
            p = (np.abs(y[:, 0]) ** 2).mean(axis=1)
            # power two channels away relative to the peak
            return p[(p.argmax() + 3) % nc] / p.max()

        assert leakage(yp) < leakage(yf) * 0.1, (leakage(yp), leakage(yf))

    def test_dc_gain_unity(self):
        nc, taps = 8, 8
        plan = PolyphasePlan(False, nc, taps)
        h = jnp.asarray(prototype_lowpass(nc, taps))
        npart = 16
        ndat = plan.block_ndat(npart)
        # tone at the centre of channel 5: unit passband gain
        c = 5
        f = -0.5 + (c + 0.5) / nc
        x = np.exp(2j * np.pi * f * np.arange(ndat)).astype(np.complex64)
        y = c_of(polyphase_filterbank_block(sc_of(x[None, None, :]), h, plan, npart))
        p = np.abs(y[:, 0]).mean(axis=1)
        assert p.argmax() == c
        assert p.max() == pytest.approx(1.0, rel=0.05)


class TestFourthMoment:
    def test_products(self, rng):
        s = rng.standard_normal((2, 4, 8)).astype(np.float32)
        m = np.asarray(fourth_moment(jnp.asarray(s)))
        assert m.shape == (2, 14, 8)
        np.testing.assert_allclose(m[:, :4], s, rtol=1e-6)
        for k, (i, j) in enumerate(PAIRS):
            np.testing.assert_allclose(m[:, 4 + k], s[:, i] * s[:, j], rtol=1e-5)


class TestCyclicFold:
    def test_lag_zero_is_power(self, rng):
        from dspsr_jax.ops.cyclic import lag_products
        x = (rng.standard_normal((1, 1, 64))
             + 1j * rng.standard_normal((1, 1, 64))).astype(np.complex64)
        cr, ci = lag_products(sc_of(x), 4)
        p0 = np.asarray(cr)[0, 0, 0]
        np.testing.assert_allclose(p0, np.abs(x[0, 0, :61]) ** 2, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(ci)[0, 0, 0], 0, atol=1e-5)

    def test_hermitian_property(self, rng):
        from dspsr_jax.ops.cyclic import lag_products
        x = (rng.standard_normal((1, 1, 128))
             + 1j * rng.standard_normal((1, 1, 128))).astype(np.complex64)
        cr, ci = lag_products(sc_of(x), 3)
        c = c_of((cr, ci))[0, 0]
        ref = x[0, 0]
        for l in range(3):
            np.testing.assert_allclose(
                c[l], ref[l:l+126] * np.conj(ref[:126]), rtol=1e-5, atol=1e-5)

    def test_pipeline_cyclic_fold(self, tmp_path):
        from dspsr_jax.models.load_to_fold import FoldConfig, load_to_fold
        from test_pipeline import synth_pulsar_dada, PERIOD, DM, PULSE_PHASE

        p = synth_pulsar_dada(str(tmp_path / "cyc.dada"), nsec=0.2)
        nc = 8
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         cyclic_nchan=nc, block_parts=2, nbin=64)
        res = load_to_fold(p, cfg)
        nlag = nc // 2 + 1
        # npol_in=2 -> planes = 2*nlag*2
        assert res.obs.npol == 2 * nlag * 2
        spec = res.cyclic_spectra()  # [nsub, nchan, npol, nbin, nchan_cyclic]
        assert spec.shape[-1] == 2 * (nlag - 1)
        # the phase-averaged lag-0 power profile carries the pulse: sum the
        # cyclic spectrum over channels = lag-0 = intensity profile
        prof = spec[0, 0, 0].sum(axis=-1)
        assert abs(prof.argmax() / res.nbin - PULSE_PHASE) < 0.06


class TestJonesConvolution:
    def test_identity_jones_matches_scalar(self, rng):
        """Identity Jones response == plain convolution per pol."""
        from dspsr_jax.ops.convolution import (
            OverlapSavePlan, overlap_save_convolve, overlap_save_convolve_jones)
        n_fft, nfp, nfn = 128, 8, 8
        plan = OverlapSavePlan(False, n_fft, nfp, nfn)
        npart = 3
        ndat = plan.block_ndat(npart)
        x = (rng.standard_normal((1, 2, ndat))
             + 1j * rng.standard_normal((1, 2, ndat))).astype(np.complex64)
        one = np.ones((1, n_fft), np.complex64)
        zero = np.zeros((1, n_fft), np.complex64)
        y_scalar = c_of(overlap_save_convolve(sc_of(x), sc_of(one), plan, npart))
        y_jones = c_of(overlap_save_convolve_jones(
            sc_of(x), (sc_of(one), sc_of(zero), sc_of(zero), sc_of(one)),
            plan, npart))
        np.testing.assert_allclose(y_jones, y_scalar, rtol=1e-5, atol=1e-5)

    def test_swap_jones(self, rng):
        """Anti-diagonal Jones swaps the polarizations."""
        from dspsr_jax.ops.convolution import (
            OverlapSavePlan, overlap_save_convolve_jones)
        n_fft = 64
        plan = OverlapSavePlan(False, n_fft, 0, 0)
        npart = 2
        ndat = plan.block_ndat(npart)
        x = (rng.standard_normal((1, 2, ndat))
             + 1j * rng.standard_normal((1, 2, ndat))).astype(np.complex64)
        one = np.ones((1, n_fft), np.complex64)
        zero = np.zeros((1, n_fft), np.complex64)
        y = c_of(overlap_save_convolve_jones(
            sc_of(x), (sc_of(zero), sc_of(one), sc_of(one), sc_of(zero)),
            plan, npart))
        np.testing.assert_allclose(y[:, 0], x[:, 1, :y.shape[-1]], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y[:, 1], x[:, 0, :y.shape[-1]], rtol=1e-4, atol=1e-4)


class TestSkyCoord:
    def test_parse_format_roundtrip(self):
        from dspsr_jax.timing.skycoord import SkyCoord
        c = SkyCoord.parse("08:35:20.61149", "-45:10:34.8751")
        assert c.ra_hms().startswith("08:35:20.61")
        assert c.dec_dms().startswith("-45:10:34.87")
        assert abs(c.sigproc_raj() - 83520.61149) < 1e-3
        assert abs(c.sigproc_dej() - (-451034.8751)) < 1e-3


class TestAutocorrelation:
    def test_tone_spectrum(self):
        from dspsr_jax.ops.autocorrelation import autocorrelation, acf_spectra
        nlag = 17
        n = 8192
        f = 0.125  # cycles/sample
        x = np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)
        acf = autocorrelation(sc_of(x[None, None, :]), nlag)
        spec = acf_spectra(acf)[0, 0]
        nfull = 2 * (nlag - 1)
        # natural order: bin k ~ freq -1/2 + k/nfull; tone at 0.125
        expect_bin = int(round((f + 0.5) * nfull))
        assert spec.argmax() == expect_bin
        # ACF of a pure tone: |acf[l]| = 1 for all lags
        mag = np.abs(c_of(acf))[0, 0]
        np.testing.assert_allclose(mag, 1.0, atol=1e-5)

    def test_acf_filterbank_time_resolved(self, rng):
        from dspsr_jax.ops.autocorrelation import acf_filterbank
        n = 4096
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        x[: n // 2] *= 10.0  # louder first half
        out = acf_filterbank(sc_of(x[None, None, :]), 5, 2)
        p = np.asarray(out[0])[0, 0, :, 0]  # lag-0 power per block
        assert p[0] > 50 * p[1] / 2  # ~100x power ratio


class TestACFilterbank:
    """dsp::ACFilterbank zero-padded PSD/ACF modes (ACFilterbank.C:40-293)."""

    def _signal(self, n=4096, seed=3):
        rng = np.random.default_rng(seed)
        c = rng.standard_normal((1, 1, n)) + 1j * rng.standard_normal((1, 1, n))
        # narrowband tone so the PSD has structure
        c += 3.0 * np.exp(2j * np.pi * 0.19 * np.arange(n))
        return c.astype(np.complex128)

    def test_psd_matches_numpy(self):
        from dspsr_jax.ops.autocorrelation import ac_filterbank
        from dspsr_jax.ops import sc
        c = self._signal()
        nchan, nlag = 64, 32
        ngood = nchan - nlag
        x = sc.from_numpy(c)
        pr, pi = ac_filterbank((jnp.asarray(x[0], jnp.float32),
                                jnp.asarray(x[1], jnp.float32)), nchan, nlag)
        nwin = c.shape[-1] // ngood
        ref = np.empty((1, 1, nwin, nchan))
        for w in range(nwin):
            seg = np.zeros(nchan, np.complex128)
            seg[:ngood] = c[0, 0, w * ngood:(w + 1) * ngood]
            ref[0, 0, w] = np.abs(np.fft.fft(seg)) ** 2
        np.testing.assert_allclose(np.asarray(pr), ref, rtol=2e-3, atol=1e-2)
        assert float(jnp.max(jnp.abs(pi))) == 0.0

    def test_acf_is_noncyclic(self):
        from dspsr_jax.ops.autocorrelation import ac_filterbank
        from dspsr_jax.ops import sc
        c = self._signal()
        nchan, nlag = 64, 32
        ngood = nchan - nlag
        x = sc.from_numpy(c)
        ar, ai = ac_filterbank((jnp.asarray(x[0], jnp.float32),
                                jnp.asarray(x[1], jnp.float32)), nchan, nlag,
                               form_acf=True)
        assert ar.shape[-1] == nlag
        # lag-l estimate per window equals the direct non-cyclic sum / nchan
        seg = c[0, 0, :ngood]
        for lag in (0, 5, 17):
            direct = np.sum(seg[lag:] * np.conj(seg[:ngood - lag]))
            # ifft's 1/N cancels the DFT pair: acf[l] = sum_t x[t+l] x*[t]
            got = complex(ar[0, 0, 0, lag], ai[0, 0, 0, lag])
            assert abs(got - direct) / max(abs(direct), 1e-9) < 5e-3


class TestOptimalFFT:
    """Measured FFT-length selection (OptimalFFT.C equivalent)."""

    def test_best_ndat_covers_smear_and_caches(self, tmp_path, monkeypatch):
        import dspsr_jax.utils.optimalfft as off
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        bench = off.FFTBench(batch=2, trials=1)
        opt = off.OptimalFFT(bench)
        n = opt.get_best_ndat(nfilt_tot=100, max_nfft=1 << 14)
        assert n > 100 and (n & (n - 1)) == 0
        # second bench instance reads the cache file, no re-timing
        bench2 = off.FFTBench(batch=2, trials=1)
        assert bench2._table == bench._table and bench2._table
        assert opt.compute_cost(n, 100) > 0


class TestCompilationCache:
    def test_enable_compilation_cache_sets_config(self, tmp_path, monkeypatch):
        """Persistent compile cache (reference OptimalFFT plan-cache
        analogue): .jax_cache/ in the checkout unless
        JAX_COMPILATION_CACHE_DIR names one, which JAX reads itself."""
        import os
        import jax
        from dspsr_jax.utils import platform

        before = jax.config.jax_compilation_cache_dir
        try:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            d = platform.enable_compilation_cache()
            assert d == os.path.join(platform.CHECKOUT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == d
            assert os.path.isdir(d)
            jax.config.update("jax_compilation_cache_dir", before)
            env = str(tmp_path / "jaxcache")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
            assert platform.enable_compilation_cache() == env
            # the code configures no directory of its own
            assert jax.config.jax_compilation_cache_dir == before
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
