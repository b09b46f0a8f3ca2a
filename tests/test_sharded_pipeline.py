"""ShardedFoldPipeline (LoadToFoldN equivalent) parity tests.

Core property (SURVEY.md §4, mirroring the reference's 1-thread vs N-thread
archive comparison): an (n_time, n_chan)-sharded run over superblocks must
equal the single-pipeline run with the same per-block geometry — including
2-bit excision weights, spectral kurtosis, Jones calibration and subints.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.io.sources import RawFileSource, DADAFile
from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
from dspsr_jax.parallel.sharded import make_mesh
from dspsr_jax.parallel.pipeline import ShardedFoldPipeline

RATE = 1e6


def _obs(nbit=8, npol=2, ndim=1):
    return Observation(
        nchan=1, npol=npol, ndim=ndim, nbit=nbit, centre_frequency=1400.0,
        bandwidth=-1.0 if ndim == 2 else -2.0, rate=RATE,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC if ndim == 2 else Signal.NYQUIST,
        source="FAKE", telescope="PKS", instrument="RAW")


def _write(tmp_path, name, nbytes, seed=5, rfi_stretch=None, twobit=False,
           floats=False):
    rng = np.random.default_rng(seed)
    if floats:
        q = rng.normal(0, 1, nbytes // 4).astype("<f4").view(np.uint8)
    elif twobit:
        # draw 2-bit codes with the JA98 Gaussian occupation (~0.677 low
        # fraction) so healthy blocks survive the excision window
        codes = rng.choice(4, size=nbytes * 4,
                           p=[0.1615, 0.3385, 0.3385, 0.1615]).astype(np.uint8)
        c = codes.reshape(-1, 4)
        q = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    else:
        q = rng.integers(0, 256, nbytes).astype(np.uint8)
    if rfi_stretch is not None:
        a, b = rfi_stretch
        q[a:b] = 255  # saturated stretch -> 2-bit excision zero-weights it
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(q.tobytes())
    return p


def _cfg(**kw):
    base = dict(folding_period=0.004, dispersion_measure=3.0, nchan=4,
                nbin=32, block_parts=2, min_block_samples=0,
                digitizer_stats=True)
    base.update(kw)
    return FoldConfig(**base)


def _parity(tmp_path, obs, cfg, n_time, n_chan, nsuper=2, name="d.raw",
            rfi_stretch=None, rtol=2e-5):
    """Run sharded vs single on identical data; compare results."""
    twobit = obs.nbit == 2 and cfg.dynamic_twobit
    floats = obs.nbit == 32
    mesh = make_mesh(n_time * n_chan, n_chan)
    # size the file to exactly nsuper superblocks (probe geometry first)
    probe_src = RawFileSource(
        _write(tmp_path, name, 1 << 22, rfi_stretch=rfi_stretch,
               twobit=twobit, floats=floats), obs)
    sh = ShardedFoldPipeline(probe_src, cfg, mesh)
    total = nsuper * sh.superblock_stride + sh.inner.nsamp_overlap
    total_bytes = int(round(total * obs.nbytes_per_sample))

    path = _write(tmp_path, name, total_bytes, rfi_stretch=rfi_stretch,
                  twobit=twobit, floats=floats)
    sh = ShardedFoldPipeline(RawFileSource(path, obs), cfg, mesh)
    res_n = sh.run()

    single = FoldPipeline(RawFileSource(path, obs), cfg)
    res_1 = single.run()

    assert res_n.profiles.shape == res_1.profiles.shape
    assert len(res_n.epochs) == len(res_1.epochs)
    for a, b in zip(res_n.epochs, res_1.epochs):
        assert abs(a - b) < 1e-12
    np.testing.assert_allclose(res_n.integration_length,
                               res_1.integration_length, rtol=1e-12)
    scale = np.abs(res_1.profiles).max() + 1e-30
    np.testing.assert_allclose(res_n.profiles / scale, res_1.profiles / scale,
                               atol=rtol)
    np.testing.assert_allclose(res_n.hits, res_1.hits, atol=1e-3)
    if res_1.digitizer_counts is not None:
        np.testing.assert_array_equal(res_n.digitizer_counts,
                                      res_1.digitizer_counts)
    return res_n, res_1


def test_parity_8bit_time_shards(tmp_path):
    _parity(tmp_path, _obs(), _cfg(), n_time=8, n_chan=1)


def test_parity_chan_shards(tmp_path):
    _parity(tmp_path, _obs(), _cfg(), n_time=4, n_chan=2)


def test_parity_2bit_excision_weights(tmp_path):
    """2-bit JA98 dynamic levels + excision weights agree sharded (the
    saturated stretch must produce zero weights in both runs)."""
    obs = _obs(nbit=2, ndim=2)  # 1 byte/sample (4 dig streams)
    res_n, res_1 = _parity(tmp_path, obs, _cfg(ndat_per_weight=128, min_block_samples=4096),
                           n_time=4, n_chan=1,
                           rfi_stretch=(10000, 12000))
    # healthy blocks survived AND the saturated stretch was excised
    assert res_1.hits.max() > 0
    assert res_1.hits.sum() < res_1.profiles.shape[1] * res_1.hits.shape[-1] \
        * res_1.hits.max()


def test_parity_spectral_kurtosis(tmp_path):
    _parity(tmp_path, _obs(), _cfg(sk_enable=True, sk_m=64),
            n_time=4, n_chan=1)


def test_parity_spectral_kurtosis_chan_sharded(tmp_path):
    """SK under CHANNEL sharding: the fscr round psums S1/S2 over the
    mesh chan axis so its thresholds use the GLOBAL Nd — identical
    excision to the single run (removes the local-Nd deviation recorded
    in PARITY.md r4; reference detect_fscr pools the whole band,
    SpectralKurtosis.C)."""
    _parity(tmp_path, _obs(), _cfg(sk_enable=True, sk_m=64),
            n_time=2, n_chan=2)


def test_parity_sk_chan_sharded_with_rfi_burst(tmp_path):
    """A saturated burst that only the GLOBAL fscr threshold catches the
    same way: chan-sharded excision weights equal the single run's."""
    res_n, res_1 = _parity(tmp_path, _obs(), _cfg(sk_enable=True, sk_m=64),
                           n_time=2, n_chan=2, rfi_stretch=(20000, 24000))
    assert res_1.hits.max() > 0


def test_parity_rfi_filter(tmp_path):
    """rfi_filter under sharding runs the same-block zap per shard and
    matches the single run."""
    res_n, _ = _parity(tmp_path, _obs(), _cfg(rfi_filter=True),
                       n_time=4, n_chan=1)


def test_parity_jones_calibration(tmp_path):
    """Matrix (Jones) convolution sharded over time."""
    rng = np.random.default_rng(2)
    freqs = np.linspace(1399.0, 1401.0, 64)
    j = np.empty((64, 2, 2), np.complex128)
    for i in range(64):
        a = 0.1 * rng.standard_normal(2)
        j[i] = np.eye(2) + np.array([[0, a[0] + 1j * a[1]],
                                     [a[0] - 1j * a[1], 0]])
    np.savez(tmp_path / "cal.npz", freq=freqs, jones=j)
    obs = _obs(ndim=2)
    cfg = _cfg(nchan=1, npol_out=4, frequency_resolution=128,
               calibration_path=str(tmp_path / "cal.npz"),
               dispersion_measure=1.0)
    _parity(tmp_path, obs, cfg, n_time=4, n_chan=1, rtol=5e-5)


def test_parity_subints_aligned(tmp_path):
    """Subint boundaries on superblock edges: identical division."""
    obs = _obs()
    mesh = make_mesh(4, 1)
    probe = ShardedFoldPipeline(
        RawFileSource(_write(tmp_path, "s.raw", 1 << 22), obs), _cfg(), mesh)
    # slightly under one superblock so the boundary is unambiguous in fp
    sb_seconds = probe.superblock_stride / RATE * 0.98
    cfg = _cfg(subint_seconds=sb_seconds)
    res_n, res_1 = _parity(tmp_path, obs, cfg, n_time=4, n_chan=1,
                           nsuper=3, name="s.raw")
    # sample-exact boundaries at 0.98/1.96/2.94 superblocks: three full
    # divisions plus the trailing 0.06-superblock sliver
    assert res_n.profiles.shape[0] == 4
    rate_out = res_n.obs.rate
    for k in range(3):
        assert abs(res_n.integration_length[k]
                   - sb_seconds) <= 1.0 / rate_out


def test_parity_subints_misaligned(tmp_path):
    """A -L boundary landing MID-superblock must divide exactly like the
    single pipeline (per-block TimeDivide): epochs, integration lengths and
    per-subint profiles all match (VERDICT r2 item 4 /
    Signal/Pulsar/TimeDivide.C)."""
    obs = _obs()
    mesh = make_mesh(4, 1)
    probe = ShardedFoldPipeline(
        RawFileSource(_write(tmp_path, "sm.raw", 1 << 22), obs), _cfg(), mesh)
    # boundary at ~1.6 per-shard blocks: crosses inside every superblock
    sub_seconds = probe.inner.stride_in_samples / RATE * 1.6
    cfg = _cfg(subint_seconds=sub_seconds)
    res_n, res_1 = _parity(tmp_path, obs, cfg, n_time=4, n_chan=1,
                           nsuper=3, name="sm.raw")
    assert res_n.profiles.shape[0] >= 4  # several subints across 3 blocks


def test_parity_subints_turns_misaligned(tmp_path):
    """--turns=1 division: multiple boundaries INSIDE every superblock
    (several per-shard division groups per dispatch)."""
    obs = _obs()
    cfg = _cfg(subint_turns=1)
    # the turns cap makes blocks ~0.2 ms while one turn is 4 ms: over 24
    # superblocks the turn boundaries land mid-superblock repeatedly
    res_n, res_1 = _parity(tmp_path, obs, cfg, n_time=4, n_chan=1,
                           nsuper=24, name="st.raw")
    assert res_n.profiles.shape[0] >= 3


def test_parity_stokes_detection(tmp_path):
    _parity(tmp_path, _obs(), _cfg(npol_out=4), n_time=4, n_chan=2)


def test_parity_fourth_moment(tmp_path):
    # -4: fourteen folded moment planes, sharded (FourthMoment.C)
    res_n, res_1 = _parity(tmp_path, _obs(),
                           _cfg(npol_out=4, fourth_moment=True),
                           n_time=4, n_chan=1)
    assert res_n.profiles.shape[2] == 14


def test_sharded_rejects_unsupported_configs(tmp_path):
    """additional_pulsars and passband are not wired through the sharded
    accumulators — they must fail loudly at construction, not silently
    drop sources / crash at trace time (ADVICE r2)."""
    obs = _obs()
    path = _write(tmp_path, "rej.raw", 1 << 20)
    mesh = make_mesh(4, 1)
    with pytest.raises(NotImplementedError):
        ShardedFoldPipeline(RawFileSource(path, obs),
                            _cfg(additional_pulsars=(0.007,)), mesh)
    with pytest.raises(NotImplementedError):
        ShardedFoldPipeline(RawFileSource(path, obs),
                            _cfg(passband=True), mesh)


def test_make_mesh_shapes():
    m = make_mesh(8, 2)
    assert m.shape == {"time": 4, "chan": 2}
    with pytest.raises(ValueError):
        make_mesh(8, 3)


def test_host_stripe_layout_disjoint(tmp_path):
    obs = _obs()
    mesh = make_mesh(8, 1)
    sh = ShardedFoldPipeline(
        RawFileSource(_write(tmp_path, "l.raw", 1 << 22), obs), _cfg(), mesh)
    stripes, tail = sh.host_stripe_layout(0)
    ends = [s + n for s, n in stripes]
    starts = [s for s, _ in stripes]
    assert starts[1:] == ends[:-1]  # contiguous, disjoint
    assert tail[0] == ends[-1]


class TestShardedSearch:
    """LoadToFilN/OutputFileShare equivalent: time-sharded digifil output
    must be byte-identical to the single pipeline (constant rescale)."""

    def _file(self, tmp_path, obs, nbytes, name="sf.raw"):
        return _write(tmp_path, name, nbytes)

    def test_sharded_digifil_bytes_match_single(self, tmp_path):
        from dspsr_jax.models.load_to_fil import FilConfig, FilPipeline
        from dspsr_jax.parallel.search import ShardedFilPipeline

        obs = _obs()
        cfg = FilConfig(nchan=4, nbits=8, dispersion_measure=2.0,
                        min_block_samples=0, block_parts=2,
                        rescale_constant=True)
        probe = ShardedFilPipeline(
            RawFileSource(_write(tmp_path, "sf.raw", 1 << 22), obs), cfg,
            make_mesh(4, 1))
        total = 2 * probe.superblock_stride + probe.nsamp_overlap
        path = _write(tmp_path, "sf.raw",
                      int(round(total * obs.nbytes_per_sample)))

        sh = ShardedFilPipeline(RawFileSource(path, obs), cfg,
                                make_mesh(4, 1))
        out_n = str(tmp_path / "n.fil")
        sh.run(out_n)

        single = FilPipeline(RawFileSource(path, obs), cfg)
        out_1 = str(tmp_path / "one.fil")
        single.run(out_1)

        a = open(out_n, "rb").read()
        b = open(out_1, "rb").read()
        # the single pipeline may process a trailing ragged block the
        # superblock grid drops; the sharded output must be a prefix
        n = min(len(a), len(b))
        assert n > 1000
        assert a[:n] == b[:n]

    def test_sharded_digifits(self, tmp_path):
        from dspsr_jax.models.load_to_fil import FilConfig
        from dspsr_jax.parallel.search import ShardedFilPipeline
        from dspsr_jax.io.cfitsio import available, CfitsioFile

        obs = _obs()
        cfg = FilConfig(nchan=4, nbits=8, dispersion_measure=2.0,
                        min_block_samples=0, block_parts=2,
                        rescale_constant=True)
        path = _write(tmp_path, "sfit.raw", 1 << 21)
        sh = ShardedFilPipeline(RawFileSource(path, obs), cfg,
                                make_mesh(4, 1))
        out = str(tmp_path / "n.sf")
        sh.run(out, format="psrfits")
        if available():
            with CfitsioFile(out) as f:
                f.move_to("SUBINT")
                assert f.num_rows() > 0


def test_parity_cyclic_fold(tmp_path):
    """CyclicFold sharded over time (lag products per shard, matching the
    reference's per-thread pipelines)."""
    obs = _obs(ndim=2)
    cfg = _cfg(nchan=1, cyclic_nchan=8, npol_out=1,
               frequency_resolution=64, dispersion_measure=1.0)
    _parity(tmp_path, obs, cfg, n_time=4, n_chan=1, rtol=5e-5)


def _obs_mc(nchan=2, nbit=8):
    """Multi-channel complex observation (chan-shardable input groups)."""
    return Observation(
        nchan=nchan, npol=2, ndim=2, nbit=nbit, centre_frequency=1400.0,
        bandwidth=-1.0, rate=RATE / nchan,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC, source="FAKE", telescope="PKS",
        instrument="RAW")


def _jones_file(tmp_path):
    rng = np.random.default_rng(2)
    freqs = np.linspace(1399.0, 1401.0, 64)
    j = np.empty((64, 2, 2), np.complex128)
    for i in range(64):
        a = 0.1 * rng.standard_normal(2)
        j[i] = np.eye(2) + np.array([[0, a[0] + 1j * a[1]],
                                     [a[0] - 1j * a[1], 0]])
    p = tmp_path / "cal.npz"
    np.savez(p, freq=freqs, jones=j)
    return str(p)


CONV = dict(frequency_resolution=256, dispersion_measure=1.0)

# sharded-vs-single parity over every feature and input format, on
# (time x chan) meshes of 4 x 1 and 2 x 2 virtual devices
SHARDED_CASES = {
    "rfi_conv_time": (dict(mc=True), dict(CONV, nchan=2, rfi_filter=True,
                                          rfi_median_width=9), 4, 1),
    "rfi_conv_chan": (dict(mc=True), dict(CONV, nchan=2, rfi_filter=True,
                                          rfi_median_width=9), 2, 2),
    "rfi_fb_chan": (dict(mc=True), dict(nchan=8, frequency_resolution=128,
                                        rfi_filter=True,
                                        rfi_median_width=9), 2, 2),
    "sk_chan": (dict(mc=True), dict(nchan=8, frequency_resolution=128,
                                    sk_enable=True, sk_m=64), 2, 2),
    "cyclic_chan": (dict(mc=True), dict(nchan=8, frequency_resolution=128,
                                        cyclic_nchan=4), 2, 2),
    "cyclic_real_time": (dict(), dict(nchan=4, frequency_resolution=256,
                                      cyclic_nchan=4), 4, 1),
    "jones_time": (dict(mc=True), dict(CONV, nchan=2, npol_out=4,
                                       calibration_path="jones"), 4, 1),
    "jones_chan": (dict(mc=True), dict(CONV, nchan=2, npol_out=4,
                                       calibration_path="jones"), 2, 2),
    "rfi_jones_chan": (dict(mc=True), dict(CONV, nchan=2, npol_out=4,
                                           calibration_path="jones",
                                           rfi_filter=True,
                                           rfi_median_width=9), 2, 2),
    "coherence_chan": (dict(mc=True), dict(nchan=8, frequency_resolution=128,
                                           detection="coherence"), 2, 2),
    "ppqq_real_chan": (dict(), dict(npol_out=2), 2, 2),
    "nthpower_time": (dict(), dict(npol_out=3), 4, 1),
    "hanning_time": (dict(), dict(fft_window="hanning"), 4, 1),
    "fixed_twobit_time": (dict(nbit=2, ndim=2), dict(dynamic_twobit=False),
                          4, 1),
    "twos_4bit_time": (dict(nbit=4, ndim=2), dict(twos_complement=True),
                       4, 1),
    "float32_time": (dict(nbit=32, ndim=2), dict(), 4, 1),
    "caspsr_time": (dict(instrument="CASPSR"), dict(), 4, 1),
    "multichan_twobit_chan": (dict(mc=True, nbit=2),
                              dict(nchan=8, frequency_resolution=128,
                                   ndat_per_weight=64), 2, 2),
}


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_matches_single(tmp_path, case):
    obskw, cfgkw, n_time, n_chan = SHARDED_CASES[case]
    obskw = dict(obskw)
    if obskw.pop("mc", False):
        obs = _obs_mc(**obskw)
    else:
        inst = obskw.pop("instrument", "RAW")
        obs = _obs(**obskw).replace(instrument=inst)
    cfgkw = dict(cfgkw, digitizer_stats=obs.nbit <= 8)
    if cfgkw.get("calibration_path") == "jones":
        cfgkw["calibration_path"] = _jones_file(tmp_path)
    _parity(tmp_path, obs, _cfg(**cfgkw), n_time=n_time, n_chan=n_chan,
            rtol=5e-5)


def test_chan_sharded_sk_subints(tmp_path):
    """Chan-sharded SK + sample-exact -L boundaries mid-shard."""
    obs = _obs_mc()
    mesh = make_mesh(4, 2)
    base = _cfg(nchan=8, frequency_resolution=128, sk_enable=True, sk_m=64,
                digitizer_stats=False)
    probe = ShardedFoldPipeline(
        RawFileSource(_write(tmp_path, "hcsub.raw", 1 << 22), obs),
        base, mesh)
    sub = probe.inner.stride_in_samples / RATE * 1.3
    cfg = dataclasses.replace(base, subint_seconds=sub)
    res_n, res_1 = _parity(tmp_path, obs, cfg, n_time=2, n_chan=2,
                           nsuper=3, name="hcsub.raw", rtol=5e-5)
    assert res_n.profiles.shape[0] >= 3
