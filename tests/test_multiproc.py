"""Multi-process fold driver parity (the MPIRoot claim, proven).

The reference validates cluster operation with test_MPIRoot over mpirun on
localhost (SURVEY.md §4); the equivalent here: 2 OS processes x 4
virtual CPU devices each, joined by ``jax.distributed``, must produce the
SAME archive as the 1-process x 8-device sharded run and the plain
single pipeline — with each process having read only its own stripes.
"""

import dataclasses
import json

import numpy as np
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.io.dada import format_ascii_header, header_from_observation
from dspsr_jax.io.sources import open_source
from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
from dspsr_jax.parallel.sharded import make_mesh
from dspsr_jax.parallel.pipeline import ShardedFoldPipeline

RATE = 1e6


def _obs():
    return Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
        bandwidth=-2.0, rate=RATE, start_time=MJD(55000, 0.2),
        state=Signal.NYQUIST, source="MPTEST", telescope="PKS",
        instrument="RAW")


def _write_dada(tmp_path, nbytes, seed=7):
    rng = np.random.default_rng(seed)
    obs = _obs()
    p = str(tmp_path / "mp.dada")
    with open(p, "wb") as f:
        f.write(format_ascii_header(header_from_observation(obs)))
        f.write(rng.integers(0, 256, nbytes).astype(np.uint8).tobytes())
    return p


CFG = dict(folding_period=0.004, dispersion_measure=3.0, nchan=4, nbin=32,
           block_parts=2, min_block_samples=1 << 15)


def test_two_process_parity(tmp_path):
    """2 processes x 4 devices == 1 process x 8 devices == single pipeline
    (profiles, hits, subint metadata, digitizer counts)."""
    from dspsr_jax.parallel.multiproc import launch_fold

    cfg = FoldConfig(**CFG)
    # size the file to exactly 2 superblocks (probe geometry first)
    probe_path = _write_dada(tmp_path, 1 << 20)
    probe = ShardedFoldPipeline(open_source(probe_path), cfg, make_mesh(8, 1))
    total = 2 * probe.superblock_stride + probe.inner.nsamp_overlap
    path = _write_dada(tmp_path, int(total * _obs().nbytes_per_sample))

    # 1-process, 8-device sharded reference
    sp = ShardedFoldPipeline(open_source(path), cfg, make_mesh(8, 1))
    r1 = sp.run()
    # plain single pipeline
    r0 = FoldPipeline(open_source(path), cfg).run()

    out = str(tmp_path / "mp_out.npz")
    d = launch_fold(path, CFG, n_procs=2, devices_per_proc=4,
                    out_path=out, timeout=420.0)

    assert d["profiles"].shape == r1.profiles.shape
    scale = np.abs(r1.profiles).max() + 1e-30
    assert np.abs(d["profiles"] - r1.profiles).max() / scale < 1e-5
    np.testing.assert_allclose(d["hits"], r1.hits, atol=1e-3)
    np.testing.assert_allclose(d["integration_length"],
                               r1.integration_length, rtol=1e-12)
    np.testing.assert_array_equal(d["digitizer_counts"],
                                  r1.digitizer_counts)
    # and the whole sharded stack equals the plain single pipeline
    scale0 = np.abs(r0.profiles).max() + 1e-30
    assert np.abs(d["profiles"] - r0.profiles).max() / scale0 < 2e-5


def test_local_stripe_assignment():
    """Each process hosts a contiguous block of time shards; in the
    single-process case all shards are local (the MPIRoot-free striping
    contract)."""
    import jax

    cfg = FoldConfig(**CFG)
    mesh = make_mesh(8, 1)

    class _FakeSrc:
        obs = _obs().replace(ndat=1 << 22)
        total_samples = 1 << 22

        def read_samples(self, start, n):
            return np.zeros(int(n * 2), np.uint8)

    pipe = ShardedFoldPipeline(_FakeSrc(), cfg, mesh)
    assert pipe.local_time_shards() == list(range(8))
    # distributed read touches only local stripes (here: all, but the
    # layout is the contract multi-host runs rely on)
    stripes, tail = pipe.host_stripe_layout(0)
    assert len(stripes) == 8
    ends = [s + n for s, n in stripes]
    assert [s for s, _ in stripes][1:] == ends[:-1]
