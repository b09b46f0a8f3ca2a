"""Polarization calibration (PolnCalibration + matrix convolution) tests."""

import numpy as np
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.ops.polncal import (
    PolnCalibration, load_jones_cal, select_from_database, jones_product,
)
from dspsr_jax.ops.response import Response


def _obs(nsamp=1 << 16, rate=1e6):
    return Observation(
        nchan=1, npol=2, ndim=2, nbit=32, centre_frequency=1400.0,
        bandwidth=4.0, rate=rate, start_time=MJD.from_mjd(55299.0),
        state=Signal.ANALYTIC, source="CAL", telescope="TEST",
        instrument="SYNTH", ndat=nsamp)


def _jones_solution(freqs):
    """Frequency-dependent leaky instrument: J = [[1, eps(f)], [eps*(f), 1]]."""
    eps = 0.3 * np.exp(2j * np.pi * (freqs - 1398.0) / 8.0)
    j = np.zeros((len(freqs), 2, 2), np.complex128)
    j[:, 0, 0] = 1.0
    j[:, 1, 1] = 1.0
    j[:, 0, 1] = eps
    j[:, 1, 0] = 0.1 * np.conj(eps)
    return j


class TestLoaders:
    def test_npz_and_text_roundtrip(self, tmp_path):
        freqs = np.linspace(1398.0, 1402.0, 16)
        j = _jones_solution(freqs)
        npz = tmp_path / "cal.npz"
        np.savez(npz, freq=freqs, jones=j)
        f1, j1 = load_jones_cal(str(npz))
        np.testing.assert_allclose(j1, j)

        txt = tmp_path / "cal.txt"
        rows = np.column_stack([freqs] + [
            arr for a in range(2) for b in range(2)
            for arr in (j[:, a, b].real, j[:, a, b].imag)])
        np.savetxt(txt, rows)
        f2, j2 = load_jones_cal(str(txt))
        np.testing.assert_allclose(j2, j, atol=1e-12)

    def test_database_selects_by_epoch(self, tmp_path):
        freqs = np.linspace(1398.0, 1402.0, 4)
        for name, scale in (("a.npz", 1.0), ("b.npz", 2.0)):
            np.savez(tmp_path / name, freq=freqs,
                     jones=scale * _jones_solution(freqs))
        db = tmp_path / "database.txt"
        db.write_text("dspsr_jax/cal database\n"
                      "a.npz 55000 55100\n"
                      "b.npz 55200 55400\n")
        assert select_from_database(str(db), 55299.0).endswith("b.npz")
        assert select_from_database(str(db), 55050.0).endswith("a.npz")
        cal = PolnCalibration.load(str(db), epoch_mjd=55299.0)
        assert cal.jones[0, 0, 0] == pytest.approx(2.0)

    def test_match_inverts(self, tmp_path):
        obs = _obs()
        freqs = np.linspace(1397.0, 1403.0, 64)
        j = _jones_solution(freqs)
        cal = PolnCalibration(freqs, j)
        resp = cal.match(obs, 1, 256)
        assert resp.phasors.shape == (1, 256, 2, 2)
        # resp is the inverse: resp @ J(f) ~ identity at a matched bin
        f = obs.centre_frequency - 0.5 * obs.bandwidth + \
            obs.bandwidth * (17 / 256)
        jf = np.empty((2, 2), np.complex128)
        for a in range(2):
            for b in range(2):
                jf[a, b] = (np.interp(f, freqs, j[:, a, b].real)
                            + 1j * np.interp(f, freqs, j[:, a, b].imag))
        ident = resp.phasors[0, 17] @ jf
        np.testing.assert_allclose(ident, np.eye(2), atol=1e-4)


class TestEndToEnd:
    def test_calibration_removes_leakage(self, tmp_path):
        """Corrupt clean dual-pol noise with a leaky Jones response; the
        calibrated fold's cross-coherence must be much smaller than the
        uncalibrated fold's."""
        from dspsr_jax.io.dada import format_ascii_header, header_from_observation
        from dspsr_jax.io.sources import DADAFile
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

        rng = np.random.default_rng(7)
        nsamp = 1 << 16
        obs = _obs(nsamp)
        clean = rng.standard_normal((2, nsamp)) + 1j * rng.standard_normal((2, nsamp))

        # apply the instrument in the frequency domain (per-bin Jones)
        freqs_bin = (obs.centre_frequency
                     + obs.bandwidth * (np.fft.fftfreq(nsamp)))
        j = _jones_solution(np.sort(freqs_bin))
        cal_freqs = np.sort(freqs_bin)
        jp = np.empty((nsamp, 2, 2), np.complex128)
        for a in range(2):
            for b in range(2):
                jp[:, a, b] = (np.interp(freqs_bin, cal_freqs, j[:, a, b].real)
                               + 1j * np.interp(freqs_bin, cal_freqs, j[:, a, b].imag))
        spec = np.fft.fft(clean, axis=-1)  # [2, nsamp]
        corrupted = np.fft.ifft(
            np.einsum("fab,bf->af", jp, spec), axis=-1)

        # write float32 DADA (TFP order: t, pol, dim)
        tfp = np.empty((nsamp, 2, 2), np.float32)
        tfp[:, :, 0] = corrupted.real.T
        tfp[:, :, 1] = corrupted.imag.T
        path = tmp_path / "leaky.dada"
        with open(path, "wb") as f:
            f.write(format_ascii_header(header_from_observation(obs)))
            f.write(tfp.tobytes())

        np.savez(tmp_path / "cal.npz", freq=cal_freqs, jones=j)

        def fold(calpath):
            cfg = FoldConfig(folding_period=1e-3, nbin=16, nchan=1,
                             npol_out=4, calibration_path=calpath,
                             frequency_resolution=512)
            pipe = FoldPipeline(DADAFile(str(path)), cfg)
            res = pipe.run()
            prof = np.asarray(res.profiles)[0, 0]  # [npol=4 Stokes, nbin]
            # uncorrelated equal-power noise: I >> Q,U,V unless the
            # instrument mixes the polarizations
            cross = np.sqrt(prof[1] ** 2 + prof[2] ** 2 + prof[3] ** 2).mean()
            auto = prof[0].mean()
            return cross / auto

        leak_uncal = fold(None)
        leak_cal = fold(str(tmp_path / "cal.npz"))
        assert leak_cal < 0.25 * leak_uncal
        assert leak_cal < 0.03
