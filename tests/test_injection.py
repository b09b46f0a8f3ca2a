"""Analytic injection suite — independent ground truth.

Unlike the golden-model tests (whose reference implementation shares
conventions with the pipeline), this suite constructs signals from pure
closed-form arithmetic and asserts the pipeline recovers the *physics*:

- a pulse train injected into pipeline output channel ``c`` (by placing a
  tone at that channel's known normalized frequency) with a per-channel
  arrival delay ``tau_c = K_DM * DM * (f_c^-2 - f_ref^-2)`` computed from
  the textbook dispersion constant must fold to a profile peaking at
  ``(phase0 + tau_c/P) mod 1`` — predicted WITHOUT running any repo DSP;
- ``FoldResult.dedispersed()`` and the -K aligned fold must line the peaks
  up across channels;
- recovered width and S/N must match the injection;
- all of it must hold identically through the single-device pipeline, with
  real or complex input, and the (time, chan)-sharded pipeline.

This mirrors the role of the reference's de-facto integration test
``Benchmark/fold.csh`` (fold a known pulsar, check the result), with the
"known pulsar" made analytic.
"""

import dataclasses

import numpy as np
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.io.sources import RawFileSource
from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

#: classic dispersion constant (Lorimer & Kramer eq. 4.7): seconds of delay
#: = K_DM * DM[pc cm^-3] * f[MHz]^-2
K_DM = 1.0 / 2.41e-4

RATE = 4e6
CF = 1400.0
NCHAN = 8
PERIOD = 0.008
PHASE0 = 0.37
WIDTH = 0.02  # fractional pulse width (gaussian sigma in turns)
DM = 30.0


def chan_freqs(obs_out):
    return np.array([obs_out.centre_frequency_of(c) for c in range(NCHAN)])


def predicted_phases(freqs, fref):
    tau = K_DM * DM * (freqs**-2.0 - fref**-2.0)
    return (PHASE0 + tau / PERIOD) % 1.0


def build_complex_baseband(tmp_path, freqs, fref, ndat, seed=9, amp=6.0):
    """Sum of per-channel tones with pulse envelopes delayed per channel.

    Channel c is addressed purely by its normalized tone frequency
    nu_c = (f_c - CF)/BW cycles/sample; its envelope pulses at
    PHASE0 + tau_c/P.  8-bit complex dual-pol DADA-less raw file.
    """
    rng = np.random.default_rng(seed)
    bw = -RATE / 1e6  # MHz, negative sideband like the reference data
    t = np.arange(ndat) / RATE
    sig = np.zeros((2, ndat), complex)
    for c, fc in enumerate(freqs):
        nu = (fc - CF) / bw  # fraction of the band = cycles/sample
        tone = np.exp(2j * np.pi * nu * np.arange(ndat))
        tau = K_DM * DM * (fc**-2.0 - fref**-2.0)
        phase = ((t - tau) / PERIOD - PHASE0) % 1.0
        d = np.minimum(phase, 1.0 - phase)
        env = 1.0 + amp * np.exp(-0.5 * (d / WIDTH) ** 2)
        for p in range(2):
            noise = (rng.standard_normal(ndat)
                     + 1j * rng.standard_normal(ndat)) / np.sqrt(2)
            sig[p] += env * noise * tone
    sig += 0.5 * (rng.standard_normal((2, ndat))
                  + 1j * rng.standard_normal((2, ndat)))

    scale = 12.0 / sig.real.std()
    tfp = np.empty((ndat, 2, 2))
    tfp[:, :, 0] = sig.real.T * scale
    tfp[:, :, 1] = sig.imag.T * scale
    q = np.clip(np.round(tfp + 127.5 - 0.5), 0, 255).astype(np.uint8)
    path = str(tmp_path / "inj.raw")
    with open(path, "wb") as f:
        f.write(q.reshape(-1).tobytes())
    return path


def _obs(ndim=2):
    # complex sampling: bandwidth == rate; real Nyquist: bandwidth == rate/2
    bw = -RATE / 1e6 if ndim == 2 else -RATE / 2e6
    return Observation(
        nchan=1, npol=2, ndim=ndim, nbit=8, centre_frequency=CF,
        bandwidth=bw, rate=RATE, start_time=MJD(55000, 0.25),
        state=Signal.ANALYTIC if ndim == 2 else Signal.NYQUIST,
        source="INJ", telescope="PKS", instrument="RAW")


def _peak_phases(res):
    prof = res.normalized().sum(axis=0)[:, 0, :]  # [nchan, nbin]
    nbin = prof.shape[1]
    return np.argmax(prof, axis=1) / nbin, prof


def _phase_dist(a, b):
    d = np.abs(a - b) % 1.0
    return np.minimum(d, 1.0 - d)


@pytest.fixture(scope="module")
def complex_setup(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("inj")
    obs = _obs(ndim=2)
    cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                     nchan=NCHAN, nbin=64, min_block_samples=1 << 16,
                     block_parts=2, coherent=True)
    # derive the output channel freqs from a tiny probe file
    path0 = str(tmp_path / "probe.raw")
    with open(path0, "wb") as f:
        f.write(np.zeros(1 << 16, np.uint8).tobytes())
    pipe0 = FoldPipeline(RawFileSource(path0, obs), cfg)
    freqs = chan_freqs(pipe0.obs_out)
    fref = freqs.max()
    path = build_complex_baseband(tmp_path, freqs, fref, ndat=1 << 19)
    return obs, cfg, path, freqs, fref


class TestComplexInjection:
    def test_peaks_at_predicted_dispersed_phases(self, complex_setup):
        obs, cfg, path, freqs, fref = complex_setup
        res = FoldPipeline(RawFileSource(path, obs), cfg).run()
        got, prof = _peak_phases(res)
        want = predicted_phases(freqs, fref)
        nbin = prof.shape[1]
        assert (_phase_dist(got, want) <= 2.5 / nbin).all(), (got, want)

    def test_dedispersed_aligns_at_reference_phase(self, complex_setup):
        obs, cfg, path, freqs, fref = complex_setup
        res = FoldPipeline(RawFileSource(path, obs), cfg).run()
        dd = res.dedispersed(ref_freq=float(fref)).sum(axis=0)[:, 0, :]
        nbin = dd.shape[1]
        pk = np.argmax(dd, axis=1) / nbin
        assert (_phase_dist(pk, PHASE0) <= 2.5 / nbin).all(), pk

    def test_interchannel_align_K(self, complex_setup):
        obs, cfg, path, freqs, fref = complex_setup
        cfgk = dataclasses.replace(cfg, interchannel_align=True)
        res = FoldPipeline(RawFileSource(path, obs), cfgk).run()
        got, prof = _peak_phases(res)
        nbin = prof.shape[1]
        # -K aligns channels to the highest frequency: all peaks at the
        # highest channel's predicted phase
        want = predicted_phases(np.full(NCHAN, fref), fref)
        assert (_phase_dist(got, want) <= 2.5 / nbin).all(), (got, want)

    def test_width_and_snr(self, complex_setup):
        obs, cfg, path, freqs, fref = complex_setup
        res = FoldPipeline(RawFileSource(path, obs), cfg).run()
        dd = res.dedispersed(ref_freq=float(fref)).sum(axis=0).sum(axis=0)[0]
        nbin = dd.shape[0]
        base = np.partition(dd, nbin // 2)[: nbin // 2].mean()
        peak = dd.max() - base
        off = np.sort(dd - base)[: nbin // 2]
        snr = peak / max(off.std(), 1e-12)
        assert snr > 10, snr
        # FWHM of the recovered pulse ~ 2.355 * WIDTH turns (+ <=2 bins of
        # dispersion/bin smearing)
        half = (dd - base) > 0.5 * peak
        fwhm_bins = half.sum()
        expect = 2.355 * WIDTH * nbin
        assert expect * 0.5 <= fwhm_bins <= expect * 2.5 + 2, (
            fwhm_bins, expect)

    def test_sharded_recovers_same_physics(self, complex_setup):
        from dspsr_jax.parallel.sharded import make_mesh
        from dspsr_jax.parallel.pipeline import ShardedFoldPipeline

        obs, cfg, path, freqs, fref = complex_setup
        cfg_s = dataclasses.replace(cfg, min_block_samples=1 << 14)
        mesh = make_mesh(8, 2)
        res = ShardedFoldPipeline(RawFileSource(path, obs), cfg_s, mesh).run()
        got, prof = _peak_phases(res)
        want = predicted_phases(freqs, fref)
        nbin = prof.shape[1]
        assert (_phase_dist(got, want) <= 2.5 / nbin).all(), (got, want)


class TestRealInputInjection:
    """Same physics through the real-Nyquist input path, at two block
    geometries."""

    @pytest.fixture(scope="class")
    def real_setup(self, tmp_path_factory):
        tmp_path = tmp_path_factory.mktemp("injr")
        obs = Observation(
            nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=CF,
            bandwidth=-RATE / 1e6 / 2, rate=RATE,
            start_time=MJD(55000, 0.25), state=Signal.NYQUIST,
            source="INJR", telescope="PKS", instrument="RAW")
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=NCHAN, nbin=64, min_block_samples=1 << 17,
                         block_parts=2)
        path0 = str(tmp_path / "probe.raw")
        with open(path0, "wb") as f:
            f.write(np.zeros(1 << 17, np.uint8).tobytes())
        pipe0 = FoldPipeline(RawFileSource(path0, obs), cfg)
        freqs = chan_freqs(pipe0.obs_out)
        fref = freqs.max()

        # real signal: cos tones at each channel's normalized frequency
        rng = np.random.default_rng(4)
        ndat = 1 << 20
        t = np.arange(ndat) / RATE
        sig = np.zeros((2, ndat))
        for c, fc in enumerate(freqs):
            g = (c + 0.5) / (2 * NCHAN)  # cycles/sample at channel centre
            tau = K_DM * DM * (fc**-2.0 - fref**-2.0)
            phase = ((t - tau) / PERIOD - PHASE0) % 1.0
            d = np.minimum(phase, 1.0 - phase)
            env = 1.0 + 6.0 * np.exp(-0.5 * (d / WIDTH) ** 2)
            for p in range(2):
                carrier = np.cos(2 * np.pi * g * np.arange(ndat)
                                 + rng.uniform(0, 2 * np.pi))
                sig[p] += env * rng.standard_normal(ndat) * 0.3 \
                    + env * carrier * 0.7
        sig += 0.5 * rng.standard_normal((2, ndat))
        scale = 12.0 / sig.std()
        q = np.clip(np.round(sig.T * scale + 127.5 - 0.5), 0,
                    255).astype(np.uint8)
        path = str(tmp_path / "injr.raw")
        with open(path, "wb") as f:
            f.write(q.reshape(-1).tobytes())
        return obs, cfg, path, freqs, fref

    @pytest.mark.parametrize("block_parts", [pytest.param(None, id="general"),
                                             pytest.param(3, id="3")])
    def test_peaks_at_predicted_phases(self, real_setup, block_parts):
        import dataclasses

        obs, cfg, path, freqs, fref = real_setup
        if block_parts is not None:
            cfg = dataclasses.replace(cfg, block_parts=block_parts,
                                      min_block_samples=0)
        pipe = FoldPipeline(RawFileSource(path, obs), cfg)
        res = pipe.run()
        got, prof = _peak_phases(res)
        want = predicted_phases(freqs, fref)
        nbin = prof.shape[1]
        assert (_phase_dist(got, want) <= 2.5 / nbin).all(), (got, want)
