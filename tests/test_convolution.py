"""Tests for overlap-save convolution and the dedispersion chirp.

Key properties (SURVEY.md §4 strategy):
- overlap-save == direct full-length frequency-domain convolution on the
  valid region (block-size invariance);
- dedispersing a signal dispersed with the conjugate chirp recovers it;
- smearing bookkeeping matches the reference formulas.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.ops.response import Response, ResponseProduct, choose_nfft
from dspsr_jax.ops.dedispersion import (
    Dedispersion,
    delay_time,
    smearing_time,
    DM_DISPERSION,
)
from dspsr_jax.ops.convolution import OverlapSavePlan, overlap_save_convolve, frame
from scutil import sc_of, c_of


def direct_convolve(x: np.ndarray, response_natural: np.ndarray,
                    complex_input: bool) -> np.ndarray:
    """Single giant-FFT cyclic convolution (numpy, float64) as ground truth.

    x: [nchan, npol, ndat]; response_natural: [nchan, nfr] is resampled onto
    the full FFT grid by the same natural-order frequency mapping.
    """
    nchan, npol, ndat = x.shape
    n = ndat if complex_input else ndat // 2
    nfr = response_natural.shape[1]
    assert n % nfr == 0, "test helper wants integer bin upsampling"
    rep = n // nfr
    # each response bin covers `rep` fine bins; natural order on both sides
    resp_full = np.repeat(response_natural, rep, axis=1)
    if complex_input:
        spec = np.fft.fft(x, axis=-1)
        spec = np.fft.fftshift(spec, axes=-1)  # natural order
        spec = spec * resp_full[:, None, :]
        spec = np.fft.ifftshift(spec, axes=-1)
        return np.fft.ifft(spec, axis=-1)
    else:
        spec = np.fft.rfft(x, axis=-1)[..., :n]
        spec = spec * resp_full[:, None, :]
        return np.fft.ifft(spec, axis=-1)


class TestPlan:
    def test_geometry_analytic(self):
        p = OverlapSavePlan(real_input=False, n_fft=1024, nfilt_pos=100, nfilt_neg=50)
        assert p.nsamp_fft == 1024
        assert p.nsamp_overlap == 150
        assert p.nsamp_step == 874
        assert p.nkeep_c == 874
        assert p.npart(1024) == 1
        assert p.npart(1024 + 874) == 2
        assert p.block_ndat(2) == 874 * 2 + 150

    def test_geometry_nyquist(self):
        # reference Convolution.C:170-179: nsamp_fft = 2*n_fft for real input
        p = OverlapSavePlan(real_input=True, n_fft=1024, nfilt_pos=64, nfilt_neg=64)
        assert p.nsamp_fft == 2048
        assert p.nsamp_overlap == 256
        assert p.nsamp_step == 2048 - 256
        assert p.nkeep_c == 1024 - 128

    def test_invalid(self):
        with pytest.raises(ValueError):
            OverlapSavePlan(real_input=False, n_fft=64, nfilt_pos=40, nfilt_neg=40).validate()

    def test_choose_nfft(self):
        n = choose_nfft(1000)
        assert n >= 2048 and (n & (n - 1)) == 0
        assert choose_nfft(0) >= 16


class TestOverlapSaveIdentity:
    """overlap-save result == direct convolution on the valid samples."""

    @pytest.mark.parametrize("nchan,npol", [(1, 1), (2, 2)])
    def test_complex_input(self, rng, nchan, npol):
        """Exact identity: a response whose impulse response h has support
        only on [0, nfilt_pos] u [-nfilt_neg, -1] makes overlap-save equal to
        direct linear convolution y[j] = sum_k h[k] x[j-k] (that support is
        precisely what impulse_pos/impulse_neg declare; Response.h:92)."""
        n_fft, nfilt_pos, nfilt_neg = 256, 32, 16
        plan = OverlapSavePlan(False, n_fft, nfilt_pos, nfilt_neg)
        npart = 4
        ndat = plan.block_ndat(npart)
        x = (rng.standard_normal((nchan, npol, ndat))
             + 1j * rng.standard_normal((nchan, npol, ndat))).astype(np.complex64)

        # compact random FIR per channel -> frequency response
        h = np.zeros((nchan, n_fft), dtype=np.complex128)
        h[:, : nfilt_pos + 1] = rng.standard_normal(
            (nchan, nfilt_pos + 1)) + 1j * rng.standard_normal((nchan, nfilt_pos + 1))
        h[:, n_fft - nfilt_neg :] = rng.standard_normal(
            (nchan, nfilt_neg)) + 1j * rng.standard_normal((nchan, nfilt_neg))
        resp_fft_order = np.fft.fft(h, axis=1)

        y = c_of(overlap_save_convolve(
            sc_of(x), sc_of(resp_fft_order), plan, npart))

        # direct linear convolution ground truth, float64
        x64 = x.astype(np.complex128)
        expect = np.zeros((nchan, npol, plan.output_ndat(npart)), np.complex128)
        for p in range(npart):
            for j in range(plan.nkeep_c):
                gin = p * plan.nsamp_step + nfilt_pos + j  # input sample index
                acc = 0.0
                for c in range(nchan):
                    acc = (
                        x64[c, :, gin - nfilt_pos : gin + 1][..., ::-1]
                        @ h[c, : nfilt_pos + 1]
                    ) + (
                        x64[c, :, gin + 1 : gin + 1 + nfilt_neg]
                        @ h[c, n_fft - nfilt_neg :][::-1]
                    )
                    expect[c, :, p * plan.nkeep_c + j] = acc
        np.testing.assert_allclose(y, expect, rtol=2e-3, atol=2e-3)

        # also verify natural-order round trip: Response.fft_order undoes
        # the fftshift used to express this response naturally
        natural = np.fft.fftshift(resp_fft_order, axes=1).astype(np.complex64)
        r = Response(phasors=natural, impulse_pos=nfilt_pos, impulse_neg=nfilt_neg)
        np.testing.assert_allclose(
            r.fft_order(complex_input=True), resp_fft_order.astype(np.complex64),
            rtol=1e-6)

    def test_block_size_invariance(self, rng):
        """Processing one long block vs two half blocks gives identical
        output (the overlap-save streaming identity, SURVEY.md §4)."""
        n_fft, nfp, nfn = 128, 16, 8
        plan = OverlapSavePlan(False, n_fft, nfp, nfn)
        npart = 6
        ndat = plan.block_ndat(npart)
        x = (rng.standard_normal((1, 2, ndat))
             + 1j * rng.standard_normal((1, 2, ndat))).astype(np.complex64)
        resp = np.exp(1j * rng.uniform(-np.pi, np.pi, (1, n_fft))).astype(np.complex64)
        rf = sc_of(np.fft.ifftshift(resp, axes=1))

        y_full = c_of(overlap_save_convolve(sc_of(x), rf, plan, npart))

        # stream in two chunks of 3 parts each; chunk 2 starts nsamp_step*3 in
        y_parts = []
        for c in range(2):
            start = c * 3 * plan.nsamp_step
            xb = x[..., start : start + plan.block_ndat(3)]
            y_parts.append(c_of(overlap_save_convolve(sc_of(xb), rf, plan, 3)))
        y_stream = np.concatenate(y_parts, axis=-1)
        np.testing.assert_array_equal(y_full, y_stream)

    def test_real_input_analytic_output(self, rng):
        """Nyquist input: output is the analytic signal at half rate.

        A real cosine at baseband frequency f appears as a complex tone at
        the matching bin with ~half the real amplitude.
        """
        n_fft = 512
        plan = OverlapSavePlan(True, n_fft, 0, 0)
        npart = 2
        ndat = plan.block_ndat(npart)
        fs = 1.0  # normalized
        k = 37  # bin index of the big rfft
        t = np.arange(ndat)
        x = np.cos(2 * np.pi * k / plan.nsamp_fft * t).astype(np.float32)[None, None, :]
        resp = np.ones((1, n_fft), dtype=np.complex64)
        y = c_of(overlap_save_convolve(jnp.asarray(x), sc_of(resp), plan, npart))
        assert y.shape == (1, 1, npart * n_fft)
        # analytic-signal convention: A*cos -> A*exp(j phi) (rfft bin k
        # holds A*nsamp_fft/2 = A*n_fft; ifft divides by n_fft)
        np.testing.assert_allclose(np.abs(y[0, 0]), 1.0, atol=1e-3)


class TestDedispersion:
    def test_delay_formula(self):
        # reference formula: D = DM/2.41e-4; delay = D*(f1^-2 - f2^-2)
        dm = 67.99
        d = delay_time(dm, 1182.0, 1582.0)
        expected = dm / DM_DISPERSION * (1182.0**-2 - 1582.0**-2)
        assert d == pytest.approx(expected)
        assert d == pytest.approx(0.08926, rel=1e-3)  # Vela over 400 MHz @ L-band

    def test_chirp_phase_formula(self):
        """Chirp phases match Dedispersion.C:534-545 evaluated directly."""
        dm, cf, bw, nchan, ndat = 10.0, 1400.0, -64.0, 4, 64
        ded = Dedispersion.build(dm, cf, bw, nchan, ndat, zap_dc=False)
        sign = -1.0
        chanwidth = bw / nchan
        binwidth = chanwidth / ndat
        lower_cfreq = cf - 0.5 * bw + 0.5 * chanwidth
        disp = 1e6 * dm / DM_DISPERSION
        for ichan in [0, 3]:
            f0 = lower_cfreq + ichan * chanwidth
            coeff = -sign * 2 * np.pi * disp / f0**2
            for ipt in [0, 1, ndat // 2, ndat - 1]:
                freq = ipt * binwidth - 0.5 * chanwidth
                phase = coeff * freq**2 / (f0 + freq)
                expect = np.exp(1j * phase)
                got = ded.phasors[ichan, ipt]
                assert abs(got - expect) < 1e-5, (ichan, ipt)

    def test_dc_zap(self):
        ded = Dedispersion.build(10.0, 1400.0, 64.0, 1, 64)
        assert ded.phasors[0, 0] == 0

    def test_impulse_lengths_positive_and_sane(self):
        ded = Dedispersion.build(67.99, 1382.0, -400.0, 64, 1024)
        assert ded.impulse_pos > 0 and ded.impulse_neg > 0
        # lower half of the lowest channel smears more than upper half
        assert ded.impulse_neg > ded.impulse_pos

    def test_dispersion_roundtrip(self, rng):
        """Disperse white noise with the conjugate chirp, dedisperse with the
        pipeline, recover the original (the physics end-to-end test)."""
        dm, cf, bw = 0.5, 1400.0, 16.0  # modest smear (~400 samples)
        nchan = 1
        n_fft = 4096
        ded = Dedispersion.build(dm, cf, bw, nchan, n_fft, zap_dc=False)
        nfp, nfn = ded.impulse_pos, ded.impulse_neg
        assert nfp + nfn < n_fft // 4

        plan = OverlapSavePlan(False, n_fft, nfp, nfn)
        npart = 3
        ndat = plan.block_ndat(npart)
        x = (rng.standard_normal((1, 1, ndat))
             + 1j * rng.standard_normal((1, 1, ndat))).astype(np.complex64)

        # disperse in one big FFT with the conjugate chirp evaluated on the
        # fine grid of the full block (float64)
        ded_fine = Dedispersion.build(dm, cf, bw, nchan, ndat, zap_dc=False)
        disp_full = direct_convolve(
            x.astype(np.complex128), np.conj(ded_fine.phasors.astype(np.complex128)), True
        ).astype(np.complex64)

        y = c_of(overlap_save_convolve(
            sc_of(disp_full),
            sc_of(Response(ded.phasors, nfp, nfn).fft_order(True)),
            plan, npart))

        # compare the interior: output sample j of window p maps to input
        # sample p*step + nfilt_pos + j
        p = 1
        a = y[0, 0, p * plan.nkeep_c : (p + 1) * plan.nkeep_c]
        b = x[0, 0, p * plan.nsamp_step + nfp : p * plan.nsamp_step + nfp + plan.nkeep_c]
        # correlation should be ~1 (chirp binning on n_fft grid vs fine grid
        # introduces small wideband error)
        corr = np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert corr > 0.99, corr


class TestResponseProduct:
    def test_multiply(self):
        a = Response(np.full((2, 8), 2.0, np.complex64), 3, 1)
        b = Response(np.full((2, 8), 0.5j, np.complex64), 2, 5)
        p = ResponseProduct.multiply([a, b])
        np.testing.assert_allclose(p.phasors, np.full((2, 8), 1.0j, np.complex64))
        assert p.impulse_pos == 3 and p.impulse_neg == 5

    def test_shape_mismatch(self):
        a = Response(np.ones((2, 8), np.complex64))
        b = Response(np.ones((2, 16), np.complex64))
        with pytest.raises(ValueError):
            ResponseProduct.multiply([a, b])
