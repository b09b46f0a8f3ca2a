"""Tests for the filterbank channelizer and detection.

Key properties:
- a pure tone lands in the correct output channel at the correct subband
  frequency, for both band senses;
- critically-sampled (freq_res=1) and resolved (freq_res>1) modes agree on
  channel power;
- the convolving filterbank (channelize + dedisperse in one pass) equals
  channelize-then-convolve;
- detection states match the cross/stokes_detect.ic formulas.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.ops.filterbank import FilterbankPlan, filterbank_block, update_observation
from dspsr_jax.ops.dedispersion import Dedispersion
from dspsr_jax.ops.convolution import OverlapSavePlan, overlap_save_convolve
from dspsr_jax.ops.response import Response
from dspsr_jax.ops import detection
from scutil import sc_of, c_of


def tone_complex(ndat, freq_cycles_per_sample, phase=0.0):
    n = np.arange(ndat)
    return np.exp(2j * np.pi * freq_cycles_per_sample * n + 1j * phase)


class TestFilterbankPlanGeometry:
    def test_no_response(self):
        p = FilterbankPlan(real_input=False, nchan_subband=8, freq_res=16)
        assert p.n_fft == 128
        assert p.nsamp_fft == 128
        assert p.nsamp_overlap == 0
        assert p.nkeep == 16
        assert p.output_ndat(3) == 48

    def test_with_response(self):
        # reference Filterbank.C:141-152
        p = FilterbankPlan(real_input=True, nchan_subband=4, freq_res=32,
                           nfilt_pos=3, nfilt_neg=5)
        assert p.nsamp_fft == 2 * 4 * 32
        assert p.nsamp_overlap == 2 * 8 * 4
        assert p.nkeep == 24

    def test_invalid(self):
        with pytest.raises(ValueError):
            FilterbankPlan(False, 4, 8, 5, 5).validate()


class TestTonePlacement:
    def test_complex_input_tone_channels(self):
        """Tone at the centre of natural channel c lands in output channel c
        as a DC (constant) subband signal."""
        nchan_sub, freq_res = 8, 16
        plan = FilterbankPlan(False, nchan_sub, freq_res)
        npart = 4
        ndat = plan.block_ndat(npart)
        # natural channel c spans fractional input freq [-1/2 + c/8, -1/2+(c+1)/8)
        # (after ifftshift of input spectrum); its centre = -1/2 + (c+.5)/8
        for c in [0, 3, 7]:
            f = -0.5 + (c + 0.5) / nchan_sub
            x = tone_complex(ndat, f).astype(np.complex64)[None, None, :]
            y = c_of(filterbank_block(sc_of(x), plan, npart))
            assert y.shape == (nchan_sub, 1, npart * freq_res)
            power = np.mean(np.abs(y) ** 2, axis=(1, 2))
            assert power.argmax() == c, (c, power)
            # tone at channel centre -> DC of the subband: constant phase
            ph = np.angle(y[c, 0])
            assert np.ptp(np.unwrap(ph)) < 1e-2

    def test_tone_off_centre_frequency(self):
        """Tone offset within a channel appears at the right subband freq."""
        nchan_sub, freq_res = 4, 64
        plan = FilterbankPlan(False, nchan_sub, freq_res)
        npart = 2
        ndat = plan.block_ndat(npart)
        c = 2
        # offset of +5 subband bins from channel centre
        df = 5 / (nchan_sub * freq_res)
        f = -0.5 + (c + 0.5) / nchan_sub + df
        x = tone_complex(ndat, f).astype(np.complex64)[None, None, :]
        y = c_of(filterbank_block(sc_of(x), plan, npart))
        sub = y[c, 0, :freq_res]  # one window worth
        spec = np.fft.fftshift(np.fft.fft(sub))
        assert np.abs(spec).argmax() == freq_res // 2 + 5

    def test_real_input_tone(self):
        """Real (Nyquist) input: baseband frequency k/nsamp_fft falls in
        channel k//freq_res (natural order ascending from the band edge)."""
        nchan_sub, freq_res = 4, 32
        plan = FilterbankPlan(True, nchan_sub, freq_res)
        npart = 2
        ndat = plan.block_ndat(npart)
        k = 2 * freq_res + 7  # channel 2, bin 7
        x = np.cos(2 * np.pi * k / plan.nsamp_fft * np.arange(ndat)).astype(np.float32)
        y = c_of(filterbank_block(jnp.asarray(x[None, None, :]), plan, npart))
        power = np.mean(np.abs(y) ** 2, axis=(1, 2))
        assert power.argmax() == 2

    def test_critically_sampled(self):
        """freq_res=1: output rate = rate/nchan, spectrum bins are samples."""
        nchan_sub = 16
        plan = FilterbankPlan(False, nchan_sub, 1)
        npart = 32
        ndat = plan.block_ndat(npart)
        c = 5
        f = -0.5 + (c + 0.5) / nchan_sub
        x = tone_complex(ndat, f).astype(np.complex64)[None, None, :]
        y = c_of(filterbank_block(sc_of(x), plan, npart))
        assert y.shape == (nchan_sub, 1, npart)
        power = np.mean(np.abs(y) ** 2, axis=(1, 2))
        assert power.argmax() == c


class TestBlockInvariance:
    def test_streaming_identity(self, rng):
        plan = FilterbankPlan(False, 4, 16, 2, 1)
        npart = 6
        ndat = plan.block_ndat(npart)
        x = (rng.standard_normal((1, 2, ndat))
             + 1j * rng.standard_normal((1, 2, ndat))).astype(np.complex64)
        y_full = c_of(filterbank_block(sc_of(x), plan, npart))
        parts = []
        for cidx in range(3):
            start = cidx * 2 * plan.nsamp_step
            xb = x[..., start : start + plan.block_ndat(2)]
            parts.append(c_of(filterbank_block(sc_of(xb), plan, 2)))
        np.testing.assert_array_equal(y_full, np.concatenate(parts, axis=-1))


class TestConvolvingFilterbank:
    def test_equals_filterbank_then_convolve(self, rng):
        """convolve_when=During == After (reference FilterbankConfig.h:23-40):
        channelizing with the chirp applied inside the big FFT must equal
        channelizing first, then per-channel overlap-save convolution."""
        nchan_sub, freq_res = 4, 64
        dm, cf, bw = 0.05, 1400.0, 8.0
        ded = Dedispersion.build(dm, cf, bw, nchan_sub, freq_res, zap_dc=False)
        nfp, nfn = ded.impulse_pos, ded.impulse_neg
        assert 0 < nfp + nfn < freq_res // 2

        plan_during = FilterbankPlan(False, nchan_sub, freq_res, nfp, nfn)
        npart = 3
        ndat = plan_during.block_ndat(npart)
        x = (rng.standard_normal((1, 1, ndat))
             + 1j * rng.standard_normal((1, 1, ndat))).astype(np.complex64)

        y_during = c_of(filterbank_block(
            sc_of(x), plan_during, npart,
            response_natural=sc_of(ded.phasors)))

        # after: plain filterbank with no discard, then overlap-save per channel
        plan_fb = FilterbankPlan(False, nchan_sub, freq_res)
        npart_fb = plan_fb.npart(ndat)
        y_fb = c_of(filterbank_block(sc_of(x), plan_fb, npart_fb))
        plan_conv = OverlapSavePlan(False, freq_res, nfp, nfn)
        resp = Response(ded.phasors, nfp, nfn)
        npart_conv = plan_conv.npart(y_fb.shape[-1])
        y_after = c_of(overlap_save_convolve(
            sc_of(y_fb[:, :, : plan_conv.block_ndat(npart_conv)]),
            sc_of(resp.fft_order(complex_input=True)),
            plan_conv, npart_conv))

        # the two paths window the stream differently; compare a common
        # interior run of samples from output sample index nfp onwards
        n = min(y_during.shape[-1], y_after.shape[-1]) - freq_res
        a = y_during[..., :n]
        b = y_after[..., :n]
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)


class TestObservationUpdate:
    def test_metadata(self):
        obs = Observation(nchan=2, npol=2, ndim=2, state=Signal.ANALYTIC,
                          rate=1e6, centre_frequency=1400.0, bandwidth=-32.0)
        plan = FilterbankPlan(False, 8, 16, 2, 2)
        out = update_observation(obs, plan)
        assert out.nchan == 16
        assert out.state == Signal.ANALYTIC
        assert out.rate == 1e6 * 16 / 128
        assert out.dual_sideband


class TestDetection:
    def test_stokes_formulas(self, rng):
        x = (rng.standard_normal((2, 2, 64))
             + 1j * rng.standard_normal((2, 2, 64))).astype(np.complex64)
        s = np.asarray(detection.detect_stokes(sc_of(x)))
        p, q = x[:, 0], x[:, 1]
        pp = np.abs(p) ** 2
        qq = np.abs(q) ** 2
        pq = np.conj(p) * q
        np.testing.assert_allclose(s[:, 0], pp + qq, rtol=1e-5)
        np.testing.assert_allclose(s[:, 1], pp - qq, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s[:, 2], 2 * pq.real, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s[:, 3], 2 * pq.imag, rtol=1e-5, atol=1e-5)

    def test_coherence_formulas(self, rng):
        x = (rng.standard_normal((1, 2, 32))
             + 1j * rng.standard_normal((1, 2, 32))).astype(np.complex64)
        s = np.asarray(detection.detect_coherence(sc_of(x)))
        p, q = x[:, 0], x[:, 1]
        np.testing.assert_allclose(s[:, 0], np.abs(p) ** 2, rtol=1e-5)
        np.testing.assert_allclose(s[:, 1], np.abs(q) ** 2, rtol=1e-5)
        np.testing.assert_allclose(s[:, 2], (np.conj(p) * q).real, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s[:, 3], (np.conj(p) * q).imag, rtol=1e-5, atol=1e-5)

    def test_stokes_coherence_consistency(self, rng):
        """I = PP+QQ, Q = PP-QQ, U = 2 Re, V = 2 Im (dsp::Detection docs)."""
        x = (rng.standard_normal((1, 2, 16))
             + 1j * rng.standard_normal((1, 2, 16))).astype(np.complex64)
        s = np.asarray(detection.detect_stokes(sc_of(x)))
        c = np.asarray(detection.detect_coherence(sc_of(x)))
        np.testing.assert_allclose(s[:, 0], c[:, 0] + c[:, 1], rtol=1e-5)
        np.testing.assert_allclose(s[:, 1], c[:, 0] - c[:, 1], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s[:, 2], 2 * c[:, 2], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s[:, 3], 2 * c[:, 3], rtol=1e-5, atol=1e-5)

    def test_intensity_and_ppqq(self, rng):
        x = (rng.standard_normal((2, 2, 16))
             + 1j * rng.standard_normal((2, 2, 16))).astype(np.complex64)
        ii = np.asarray(detection.detect(sc_of(x), Signal.INTENSITY))
        ppqq = np.asarray(detection.detect(sc_of(x), Signal.PPQQ))
        assert ii.shape == (2, 1, 16)
        assert ppqq.shape == (2, 2, 16)
        np.testing.assert_allclose(ii[:, 0], ppqq.sum(axis=1), rtol=1e-5)
