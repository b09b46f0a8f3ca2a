"""Golden-model tests: the device pipeline (the XLA chain) against the
independent float64 numpy model of the whole chain (dspsr_jax.golden).

Each case runs ``FoldPipeline`` over two blocks of a seeded file and folds
the same bytes through ``golden.fold_run``; agreement to float32
tolerances validates every ordering, offset and normalization decision of
one configuration at once.  The fold period spans a whole number of output
samples per phase bin with a half-sample phase offset
(``golden.exact_fold``), so both sides assign every sample to the same bin
and hits agree exactly.
"""

import dataclasses

import numpy as np
import pytest

from dspsr_jax import golden
from dspsr_jax.io.sources import RawFileSource
from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD

RATE = 2e6
NBIN = 32


def make_obs(nbit=8, ndim=2, nchan=1, npol=2, instrument="RAW"):
    bw = -2.0
    rate = (RATE if ndim == 2 else 2 * RATE) / nchan
    return Observation(
        nchan=nchan, npol=npol, ndim=ndim, nbit=nbit,
        centre_frequency=1400.0, bandwidth=bw, rate=rate,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC if ndim == 2 else Signal.NYQUIST,
        source="GOLD", telescope="PKS", instrument=instrument)


def make_bytes(obs, nsamp, seed=11, kind="uniform"):
    """Seeded raw bytes for ``nsamp`` samples of ``obs``.

    uniform: every code equally likely; ja98: 2-bit codes with the
    Gaussian occupation and one saturated stretch (excised); burst: 8-bit
    Gaussian noise with one loud stretch (SK excises it); tone: 8-bit
    Gaussian noise plus a strong narrow-band tone (zapped by -R); float:
    float32 Gaussian samples."""
    rng = np.random.default_rng(seed)
    nval = nsamp * obs.nchan * obs.npol * obs.ndim
    if kind == "float":
        return rng.normal(0, 1, nval).astype("<f4").view(np.uint8)
    if kind == "ja98":
        codes = rng.choice(4, size=nval, p=[0.1615, 0.3385, 0.3385, 0.1615])
        a = nval // 3
        codes[a: a + 4096] = 3
        c = codes.reshape(-1, 4).astype(np.uint8)
        return (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    if kind == "burst":
        v = rng.normal(0, 12, (nsamp, obs.nchan * obs.npol * obs.ndim))
        v[nsamp // 3: nsamp // 3 + 2048] *= 6.0
        return np.clip(np.round(v + 127.5), 0, 255).astype(np.uint8).reshape(-1)
    if kind == "tone":
        v = rng.normal(0, 12, (nsamp, obs.nchan, obs.npol, obs.ndim))
        t = np.arange(nsamp)[:, None, None]
        v[..., 0] += 25 * np.cos(2 * np.pi * 0.1234 * t)
        if obs.ndim == 2:
            v[..., 1] += 25 * np.sin(2 * np.pi * 0.1234 * t)
        return np.clip(np.round(v + 127.5), 0, 255).astype(np.uint8).reshape(-1)
    return rng.integers(0, 256, nval * obs.nbit // 8).astype(np.uint8)


def write_jones(tmp_path, nfreq=64, seed=2):
    """A seeded calibration solution (PolnCalibration npz format)."""
    rng = np.random.default_rng(seed)
    j = np.empty((nfreq, 2, 2), np.complex128)
    for i in range(nfreq):
        a = 0.1 * rng.standard_normal(4)
        j[i] = np.eye(2) + np.array([[a[0], a[1] + 1j * a[2]],
                                     [a[1] - 1j * a[2], -a[3]]])
    p = tmp_path / "cal.npz"
    np.savez(p, freq=np.linspace(1398.0, 1402.0, nfreq), jones=j)
    return str(p)


def run_case(tmp_path, obs, cfgkw, kind="uniform", nblocks=2, seed=11):
    """(pipeline result, golden accumulation, pipeline) over ``nblocks``."""
    base = dict(dispersion_measure=0.02, nchan=4, frequency_resolution=64,
                nbin=NBIN, block_parts=2, min_block_samples=0,
                folding_period=0.004, digitizer_stats=False)
    base.update(cfgkw)
    if base.get("calibration_path") == "jones":
        base["calibration_path"] = write_jones(tmp_path)
    path = str(tmp_path / "g.raw")
    make_bytes(obs, 1 << 15, seed, kind).tofile(path)
    cfg = FoldConfig(**base)
    probe = FoldPipeline(RawFileSource(path, obs), cfg)
    period, ref = golden.exact_fold(probe.obs_out.rate, NBIN, 0.004)
    cfg = dataclasses.replace(cfg, folding_period=period,
                              reference_phase=ref)
    pipe = FoldPipeline(RawFileSource(path, obs), cfg)
    res = pipe.run(max_blocks=nblocks)
    gold = golden.fold_run(
        FoldPipeline(RawFileSource(path, obs), cfg), nblocks)
    return res, gold, pipe


def assert_matches(res, gold, tol=2e-5):
    assert res.profiles.shape[0] == 1
    got = res.profiles[0]
    want = gold["profiles"]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    assert err < tol, err
    np.testing.assert_allclose(res.hits[0], gold["hits"], rtol=0, atol=1e-3)


# input formats: bits, code conventions, interleaves, real/complex,
# multi-channel, JA98 dynamic and fixed 2-bit
@pytest.mark.parametrize("nchan,freq_res", [(4, 64), (1, 256)])
def test_pipeline_matches_golden_model(tmp_path, nchan, freq_res):
    """8-bit complex input through the convolving filterbank (nchan 4)
    and the nsub == 1 convolution (nchan 1)."""
    cfgkw = dict(nchan=nchan, frequency_resolution=freq_res,
                 dispersion_measure=0.02 if nchan > 1 else 0.005)
    res, gold, pipe = run_case(tmp_path, make_obs(), cfgkw)
    assert (pipe.fb_plan is not None) == (nchan > 1)
    assert_matches(res, gold)


FORMATS = {
    "8bit_real_fb": (dict(ndim=1), dict(), "uniform"),
    "8bit_real_conv": (dict(ndim=1), dict(nchan=1, frequency_resolution=256,
                                          dispersion_measure=0.005),
                       "uniform"),
    "8bit_twos_real": (dict(ndim=1), dict(twos_complement=True), "uniform"),
    "1bit_real_4chan": (dict(nbit=1, ndim=1, nchan=4), dict(nchan=16),
                        "uniform"),
    "2bit_fixed_complex": (dict(nbit=2), dict(dynamic_twobit=False),
                           "uniform"),
    "2bit_fixed_twos_real_2chan": (dict(nbit=2, ndim=1, nchan=2),
                                   dict(dynamic_twobit=False, nchan=8,
                                        twos_complement=True), "uniform"),
    "2bit_ja98_complex": (dict(nbit=2), dict(ndat_per_weight=128), "ja98"),
    "4bit_real": (dict(nbit=4, ndim=1), dict(), "uniform"),
    "4bit_twos_complex": (dict(nbit=4), dict(twos_complement=True),
                          "uniform"),
    "32bit_float_complex": (dict(nbit=32), dict(), "float"),
    "caspsr_interleave": (dict(ndim=1, instrument="CASPSR"), dict(),
                          "uniform"),
    "multichan_complex_fb": (dict(nchan=2), dict(nchan=8), "uniform"),
    "multichan_complex_conv": (dict(nchan=2),
                               dict(nchan=2, frequency_resolution=256,
                                    dispersion_measure=0.005), "uniform"),
    "multichan_ja98": (dict(nbit=2, nchan=2), dict(nchan=8,
                                                   ndat_per_weight=128),
                       "ja98"),
}


@pytest.mark.parametrize("case", sorted(FORMATS))
def test_formats_match_golden(tmp_path, case):
    obskw, cfgkw, kind = FORMATS[case]
    res, gold, pipe = run_case(tmp_path, make_obs(**obskw), cfgkw, kind)
    assert_matches(res, gold)
    if kind == "ja98":
        # the saturated stretch was excised on both sides
        assert gold["hits"].sum() < gold["hits"].max() * gold["hits"].size


# detection states, fourth moments, apodization, Jones, nsub == 1
CHAIN = {
    "ppqq": dict(npol_out=2),
    "pp": dict(detection="pp"),
    "qq": dict(detection="qq"),
    "coherence": dict(detection="coherence"),
    "stokes": dict(npol_out=4),
    "nthpower": dict(npol_out=3),
    "fourth_moment": dict(npol_out=4, fourth_moment=True),
    "hanning_fb": dict(fft_window="hanning"),
    "tukey_conv": dict(fft_window="tukey", nchan=1, frequency_resolution=256,
                       dispersion_measure=0.005),
    "jones_conv": dict(calibration_path="jones", nchan=1, npol_out=4,
                       frequency_resolution=256, dispersion_measure=0.005),
    "jones_nodm": dict(calibration_path="jones", nchan=1, npol_out=4,
                       frequency_resolution=128, dispersion_measure=0.0),
    "incoherent_fb": dict(dispersion_measure=0.0, frequency_resolution=None,
                          nchan=16),
}


@pytest.mark.parametrize("case", sorted(CHAIN))
@pytest.mark.parametrize("ndim", [2, 1])
def test_chain_matches_golden(tmp_path, case, ndim):
    res, gold, pipe = run_case(tmp_path, make_obs(ndim=ndim), CHAIN[case])
    assert_matches(res, gold)
