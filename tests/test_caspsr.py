"""CASPSR format backend: 8-bit two's-complement, 4-sample pol-interleaved
blocks (reference ``Kernel/Formats/caspsr/CASPSRSingleUnpacker.C:103-151``;
``matches()`` keys on machine == "CASPSR" && nbit == 8).  The benchmark
header (``Benchmark/header.dada:15``) uses this instrument, so the flagship
configuration's real byte stream must unpack bit-exactly on every engine.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD

RATE = 2e6


def _obs(instrument="CASPSR", **kw):
    base = dict(nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
                bandwidth=-2.0, rate=RATE,
                start_time=MJD.from_utc("2010-04-13-02:05:45"),
                state=Signal.NYQUIST, source="FAKE", telescope="PKS",
                instrument=instrument)
    base.update(kw)
    return Observation(**base)


def _caspsr_bytes(signed_tp):
    """[t, pol] int8 samples -> CASPSR byte stream
    ([p0 t0..t3][p1 t0..t3][p0 t4..t7]...)."""
    ndat = signed_tp.shape[0]
    assert ndat % 4 == 0
    blk = signed_tp.reshape(ndat // 4, 4, 2)          # [blk, t, pol]
    return np.ascontiguousarray(
        blk.transpose(0, 2, 1)).reshape(-1).view(np.uint8)


def test_unpack_plan_detects_caspsr():
    from dspsr_jax.unpack.unpackers import UnpackPlan

    plan = UnpackPlan(_obs())
    assert plan.layout == "caspsr" and plan.twos_complement
    plan2 = UnpackPlan(_obs(instrument="RAW"))
    assert plan2.layout == "tfp" and not plan2.twos_complement


def test_caspsr_unpack_matches_reordered_stream(rng):
    """CASPSR bytes unpack to the same voltages as the equivalent plain TFP
    two's-complement stream."""
    from dspsr_jax.unpack.unpackers import UnpackPlan

    ndat = 4096
    signed = rng.integers(-128, 128, (ndat, 2)).astype(np.int8)
    raw_c = _caspsr_bytes(signed)
    raw_t = signed.reshape(-1).view(np.uint8)

    x_c, _ = UnpackPlan(_obs()).unpack(jnp.asarray(raw_c))
    x_t, _ = UnpackPlan(_obs(instrument="RAW"),
                        twos_complement=True).unpack(jnp.asarray(raw_t))
    assert np.array_equal(np.asarray(x_c), np.asarray(x_t))


@pytest.mark.parametrize("nchan", [pytest.param(4, id="general"),
                                   pytest.param(1, id="nsub1")])
def test_caspsr_fold_parity(tmp_path, rng, nchan):
    """A CASPSR file folds identically to the equivalent TFP
    two's-complement file, through the filterbank (nchan 4) and the
    nsub == 1 convolution (nchan 1)."""
    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    ndat = 1 << 15
    t = np.arange(ndat) / RATE
    noise = rng.normal(0, 18, (ndat, 2))
    noise[(t % 0.005) < 0.00025] *= 3.0
    signed = np.clip(np.round(noise), -128, 127).astype(np.int8)

    p_c = str(tmp_path / "caspsr.raw")
    with open(p_c, "wb") as f:
        f.write(_caspsr_bytes(signed).tobytes())
    p_t = str(tmp_path / "tfp.raw")
    with open(p_t, "wb") as f:
        f.write(signed.reshape(-1).view(np.uint8).tobytes())

    cfg = FoldConfig(folding_period=0.005, dispersion_measure=5.0,
                     nchan=nchan, nbin=32, block_parts=2, min_block_samples=0,
                     digitizer_stats=False)
    pipe_c = FoldPipeline(RawFileSource(p_c, _obs()), cfg)
    assert pipe_c.unpack_plan.layout == "caspsr"
    assert pipe_c.unpack_plan.twos_complement
    res_c = pipe_c.run()

    cfg_t = FoldConfig(folding_period=0.005, dispersion_measure=5.0,
                       nchan=nchan,
                       nbin=32, block_parts=2, min_block_samples=0,
                       digitizer_stats=False, twos_complement=True)
    pipe_t = FoldPipeline(RawFileSource(p_t, _obs(instrument="RAW")), cfg_t)
    res_t = pipe_t.run()

    a, b = np.asarray(res_c.profiles), np.asarray(res_t.profiles)
    assert np.abs(a - b).max() / (np.abs(b).max() + 1e-30) < 1e-5
    assert np.array_equal(np.asarray(res_c.hits), np.asarray(res_t.hits))


def test_caspsr_dada_end_to_end(tmp_path, rng):
    """A DADA file with INSTRUMENT CASPSR (the benchmark header's own
    instrument) opens through the registry and recovers the pulse."""
    from dspsr_jax.io.dada import format_ascii_header, header_from_observation
    from dspsr_jax.io.sources import open_source
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    ndat = 1 << 17
    t = np.arange(ndat) / RATE
    noise = rng.normal(0, 10, (ndat, 2))
    noise[(t % 0.004) < 0.0002] *= 6.0
    signed = np.clip(np.round(noise), -128, 127).astype(np.int8)
    obs = _obs().replace(ndat=ndat)
    path = str(tmp_path / "caspsr.dada")
    with open(path, "wb") as f:
        f.write(format_ascii_header(header_from_observation(obs)))
        f.write(_caspsr_bytes(signed).tobytes())

    src = open_source(path)
    assert src.obs.instrument.upper() == "CASPSR"
    pipe = FoldPipeline(src, FoldConfig(
        folding_period=0.004, dispersion_measure=5.0, nchan=4, nbin=64,
        block_parts=2, min_block_samples=0, digitizer_stats=False))
    res = pipe.run()
    prof = res.normalized()[0].sum(axis=(0, 1))
    snr = (prof.max() - np.median(prof)) / (prof.std() + 1e-9)
    assert snr > 1.5


def test_caspsr_search_mode(tmp_path, rng):
    """digifil-style search over CASPSR input writes the same filterbank
    as the equivalent plain TFP two's-complement stream (identical block
    geometry => bit-identical requantized output)."""
    from dspsr_jax.io.sources import RawFileSource, open_source
    from dspsr_jax.models.load_to_fil import FilConfig, FilPipeline

    ndat = 1 << 15
    signed = np.clip(np.round(rng.normal(0, 18, (ndat, 2))),
                     -128, 127).astype(np.int8)
    p_c = str(tmp_path / "caspsr.raw")
    with open(p_c, "wb") as f:
        f.write(_caspsr_bytes(signed).tobytes())
    p_t = str(tmp_path / "tfp.raw")
    with open(p_t, "wb") as f:
        f.write(signed.reshape(-1).view(np.uint8).tobytes())

    cfg = FilConfig(nchan=8, nbits=8, npol_out=1, dispersion_measure=5.0)
    pipe_c = FilPipeline(RawFileSource(p_c, _obs()), cfg)
    out_c = str(tmp_path / "c.fil")
    pipe_c.run(out_c)

    cfg_t = FilConfig(nchan=8, nbits=8, npol_out=1,
                      dispersion_measure=5.0, twos_complement=True)
    pipe_t = FilPipeline(RawFileSource(p_t, _obs(instrument="RAW")), cfg_t)
    out_t = str(tmp_path / "t.fil")
    pipe_t.run(out_t)

    a = open_source(out_c)
    b = open_source(out_t)
    da = a.read_samples(0, a.total_samples)
    db = b.read_samples(0, b.total_samples)
    assert da.size == db.size and da.size > 0
    assert np.array_equal(da, db)
