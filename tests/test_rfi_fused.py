"""Spectral RFI filter (-R): the median-bandpass zap of each block from
its own spectra.

The reference recomputes the RFIFilter zap mask from the measured bandpass
on a time interval and multiplies it into the convolution response via
ResponseProduct (``Signal/General/RFIFilter.C``).  Here every block is
zapped with the mask measured on that same block: after the response in
the convolving filterbank (ops.filterbank.apply_response_chunked), from the
pre-response spectra on the nsub == 1 convolution path
(ops.convolution.zap_rfi).  Exact masks are checked against the float64
model in test_golden_features.py; these tests check the physics.
"""

import numpy as np
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD

RATE = 2e6


def _obs():
    return Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
        bandwidth=-2.0, rate=RATE,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.NYQUIST, source="FAKE", telescope="PKS",
        instrument="RAW")


def _config(**kw):
    from dspsr_jax.models.load_to_fold import FoldConfig

    base = dict(folding_period=0.005, dispersion_measure=5.0, nchan=8,
                nbin=32, block_parts=16, min_block_samples=0,
                digitizer_stats=False)
    base.update(kw)
    return FoldConfig(**base)


def _write(tmp_path, ndat, tone_frac=None, tone_amp=0.0, seed=5):
    """8-bit dual-pol real noise, optional CW tone at tone_frac of the
    Nyquist band."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 8, (ndat, 2))
    if tone_frac is not None:
        t = np.arange(ndat)
        v += tone_amp * np.cos(np.pi * tone_frac * t)[:, None]
    q = np.clip(np.round(v + 127.5), 0, 255).astype(np.uint8)
    p = str(tmp_path / "rfi.raw")
    with open(p, "wb") as f:
        f.write(q.reshape(-1).tobytes())
    return p


def _run(path, cfg):
    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldPipeline

    pipe = FoldPipeline(RawFileSource(path, _obs()), cfg)
    return pipe, pipe.run()


def test_single_block_run_stays_fused_and_filters(tmp_path):
    """A source yielding exactly ONE block is filtered: the mask comes
    from the block itself."""
    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldPipeline

    nchan, tone_frac = 8, 0.44
    # probe the block size, then write exactly one block of samples
    probe_path = _write(tmp_path, 1 << 15)
    probe = FoldPipeline(RawFileSource(probe_path, _obs()),
                         _config(rfi_filter=True))
    ndat = probe.block_in_samples
    path = _write(tmp_path, ndat, tone_frac=tone_frac, tone_amp=60.0)
    pipe_on, on = _run(path, _config(rfi_filter=True))
    _, off = _run(path, _config(rfi_filter=False))
    mon = on.normalized().mean(axis=(0, 2, 3))
    moff = off.normalized().mean(axis=(0, 2, 3))
    tone_chan = int(tone_frac * nchan)
    others = [c for c in range(nchan) if c != tone_chan]
    assert moff[tone_chan] > 3.0 * np.median(moff[others])
    # the single block IS filtered
    assert mon[tone_chan] < 0.2 * moff[tone_chan]


def test_fused_rfi_clean_noise_matches_nofilter(tmp_path):
    """With no interference the mask stays all ones: the RFI run equals
    the unfiltered run."""
    path = _write(tmp_path, 1 << 16)
    pipe_a, a = _run(path, _config(rfi_filter=True, passband=True))
    pipe_b, b = _run(path, _config(rfi_filter=False, passband=True))
    pa, pb = a.normalized(), b.normalized()
    assert np.abs(pa - pb).max() / np.abs(pb).max() < 1e-5
    np.testing.assert_allclose(a.hits, b.hits, rtol=0, atol=0)


@pytest.mark.parametrize("nchan", [pytest.param(8, id="xla"),
                                   pytest.param(4, id="nchan4")])
def test_rfi_tone_suppressed(tmp_path, nchan):
    """A strong CW tone is excised from its output channel."""
    tone_frac = 0.44  # within output channel floor(0.44*nchan)
    path = _write(tmp_path, 1 << 17, tone_frac=tone_frac, tone_amp=60.0)
    pipe_on, on = _run(path, _config(rfi_filter=True, nchan=nchan))
    _, off = _run(path, _config(rfi_filter=False, nchan=nchan))
    # mean folded power per channel, hits-normalized
    mon = on.normalized().mean(axis=(0, 2, 3))   # [nchan]
    moff = off.normalized().mean(axis=(0, 2, 3))
    tone_chan = int(tone_frac * nchan)
    others = [c for c in range(nchan) if c != tone_chan]
    # without the filter the tone dominates its channel
    assert moff[tone_chan] > 3.0 * np.median(moff[others])
    # with the filter the tone channel drops to near the noise floor
    assert mon[tone_chan] < 0.35 * moff[tone_chan]
    # other channels unaffected
    np.testing.assert_allclose(mon[others], moff[others], rtol=0.05)


def test_rfi_plus_sk_combined(tmp_path):
    """RFI filter AND in-stream SK compose in one program: the tone
    channel ends near the noise floor (zap mask + SK weights), while the
    unfiltered run shows the tone plainly."""
    tone_frac = 0.44
    path = _write(tmp_path, 1 << 17, tone_frac=tone_frac, tone_amp=60.0)
    pipe, on = _run(path, _config(rfi_filter=True, sk_enable=True, sk_m=64,
                                  sk_no_fscr=True))
    assert pipe.sk_plan is not None
    _, off = _run(path, _config())  # no filtering at all
    mon = on.normalized().mean(axis=(0, 2, 3))
    moff = off.normalized().mean(axis=(0, 2, 3))
    tone_chan = int(tone_frac * 8)
    others = [c for c in range(8) if c != tone_chan]
    assert moff[tone_chan] > 3.0 * np.median(moff[others])
    # combined filtering removes most of the tone (the same-block median
    # zap leaves the tone's spectral leakage below its threshold; SK may
    # zap the whole channel -> 0 is acceptable)
    assert mon[tone_chan] < 0.35 * moff[tone_chan]


def _jones_npz(tmp_path, nf=64, lo=1398.0, hi=1400.0):
    rng = np.random.default_rng(7)
    freqs = np.linspace(lo, hi, nf)
    j = np.empty((nf, 2, 2), np.complex128)
    for i in range(nf):
        a = 0.1 * rng.standard_normal(2)
        j[i] = np.eye(2) + np.array([[0, a[0] + 1j * a[1]],
                                     [a[0] - 1j * a[1], 0]])
    p = str(tmp_path / "cal.npz")
    np.savez(p, freq=freqs, jones=j)
    return p


def _conv_tone_file(tmp_path, name, ndat=1 << 16, nchan=2, tone_chan=1,
                    tone_amp=50.0, seed=9):
    """Channelized complex 8-bit TFP stream with a CW tone inside one
    channel's band."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 8, (ndat, nchan, 2, 2))
    t = np.arange(ndat)
    v[:, tone_chan, :, 0] += tone_amp * np.cos(0.31 * np.pi * t)[:, None]
    v[:, tone_chan, :, 1] += tone_amp * np.sin(0.31 * np.pi * t)[:, None]
    q = np.clip(np.round(v + 127.5), 0, 255).astype(np.uint8)
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(q.reshape(-1).tobytes())
    return p


def _conv_obs(nchan=2):
    return Observation(
        nchan=nchan, npol=2, ndim=2, nbit=8, centre_frequency=1400.0,
        bandwidth=-2.0, rate=RATE / nchan,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC, source="FAKE", telescope="PKS",
        instrument="RAW")


def test_rfi_jones_fused_tone_suppressed(tmp_path):
    """-R combined with a Jones calibration: the zap of the pre-response
    spectra composes with the 2x2 response, and a CW tone is excised
    while calibration still applies.  Jones lives on the convolution
    (nsub == 1) path, as in the reference's matrix Convolution."""
    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    cal = _jones_npz(tmp_path)
    p = _conv_tone_file(tmp_path, "jrfi.raw")
    obs = _conv_obs()
    base = dict(folding_period=0.005, dispersion_measure=5.0, nchan=2,
                frequency_resolution=1024, nbin=32, block_parts=4,
                min_block_samples=0, digitizer_stats=False,
                npol_out=4, calibration_path=cal)

    def run(**kw):
        pipe = FoldPipeline(RawFileSource(p, obs),
                            FoldConfig(**{**base, **kw}))
        return pipe, pipe.run()

    pipe_on, on = run(rfi_filter=True)
    assert pipe_on.jones_response is not None
    _, off = run(rfi_filter=False)
    # Stokes I channel powers
    mon = on.normalized()[:, :, 0].mean(axis=(0, 2))
    moff = off.normalized()[:, :, 0].mean(axis=(0, 2))
    assert moff[1] > 3.0 * moff[0]
    assert mon[1] < 0.35 * moff[1]
    np.testing.assert_allclose(mon[0], moff[0], rtol=0.05)


def test_rfi_conv_nsub1_fused(tmp_path):
    """-R on already-channelized input with NO further channelization
    (nsub == 1 pure convolution): the zap runs across each channel's
    n_fft bins before the chirp."""
    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    rng = np.random.default_rng(9)
    ndat, nchan = 1 << 16, 2
    v = rng.normal(0, 8, (ndat, nchan, 2, 2))
    # complex CW tone inside channel 1's band
    t = np.arange(ndat)
    v[:, 1, :, 0] += 50.0 * np.cos(0.31 * np.pi * t)[:, None]
    v[:, 1, :, 1] += 50.0 * np.sin(0.31 * np.pi * t)[:, None]
    q = np.clip(np.round(v + 127.5), 0, 255).astype(np.uint8)
    p = str(tmp_path / "conv_rfi.raw")
    with open(p, "wb") as f:
        f.write(q.reshape(-1).tobytes())
    obs = Observation(
        nchan=nchan, npol=2, ndim=2, nbit=8, centre_frequency=1400.0,
        bandwidth=-2.0, rate=RATE / nchan,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC, source="FAKE", telescope="PKS",
        instrument="RAW")
    base = dict(folding_period=0.005, dispersion_measure=5.0, nchan=nchan,
                frequency_resolution=1024, nbin=32, block_parts=4,
                min_block_samples=0, digitizer_stats=False)

    def run(**kw):
        cfg = FoldConfig(**{**base, **kw})
        pipe = FoldPipeline(RawFileSource(p, obs), cfg)
        return pipe, pipe.run()

    pipe_on, on = run(rfi_filter=True)
    assert pipe_on.conv_plan is not None and pipe_on.fb_plan is None
    _, off = run(rfi_filter=False)
    mon = on.normalized().mean(axis=(0, 2, 3))
    moff = off.normalized().mean(axis=(0, 2, 3))
    # the tone dominates channel 1 unfiltered; zapped it returns near
    # the clean channel's level
    assert moff[1] > 3.0 * moff[0]
    assert mon[1] < 0.35 * moff[1]
    np.testing.assert_allclose(mon[0], moff[0], rtol=0.05)


def test_rfi_same_block_two_pass(tmp_path):
    """Each block is zapped with the mask measured on that same block —
    the reference's same-interval semantics, state-free.  The tone is
    excised; clean noise passes through untouched (mask of ones)."""
    tone_frac = 0.44
    path = _write(tmp_path, 1 << 16, tone_frac=tone_frac, tone_amp=60.0)
    pipe_h, on = _run(path, _config(rfi_filter=True))
    _, off = _run(path, _config(rfi_filter=False))
    mon = on.normalized().mean(axis=(0, 2, 3))
    moff = off.normalized().mean(axis=(0, 2, 3))
    tc = int(tone_frac * 8)
    others = [c for c in range(8) if c != tc]
    assert moff[tc] > 3.0 * np.median(moff[others])
    assert mon[tc] < 0.35 * moff[tc]
    np.testing.assert_allclose(mon[others], moff[others], rtol=0.05)
    # clean noise: the mask stays all ones -> equals the unfiltered run
    clean = _write(tmp_path, 1 << 16)
    _, a = _run(clean, _config(rfi_filter=True, passband=True))
    _, b = _run(clean, _config(rfi_filter=False, passband=True))
    pa, pb = a.normalized(), b.normalized()
    assert np.abs(pa - pb).max() / np.abs(pb).max() < 1e-5
    np.testing.assert_allclose(a.hits, b.hits, rtol=0, atol=0)
