"""Native host I/O runtime tests (prefetch reader + SHM ring)."""

import os
import threading
import time

import numpy as np
import pytest

from dspsr_jax.io.hostio import (
    load_hostio, PrefetchSource, RingWriter, RingReader,
)
from dspsr_jax.io.sources import open_source
from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD
from test_pipeline import synth_pulsar_dada, RATE


@pytest.fixture(scope="module")
def lib():
    return load_hostio()


class TestPrefetch:
    def test_matches_direct_reads(self, lib, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "pf.dada"), nsec=0.05)
        direct = open_source(p)
        block, stride = 40000, 32000  # overlapping blocks
        pf = PrefetchSource(open_source(p), block, stride)
        start = 0
        n = 0
        while start + block <= direct.total_samples:
            a = pf.read_samples(start, block)
            b = direct.read_samples(start, block)
            np.testing.assert_array_equal(a, b)
            start += stride
            n += 1
        assert n >= 3
        pf.close()

    def test_fallback_random_access(self, lib, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "pf2.dada"), nsec=0.02)
        direct = open_source(p)
        pf = PrefetchSource(open_source(p), 8192, 8192)
        np.testing.assert_array_equal(
            pf.read_samples(5000, 100), direct.read_samples(5000, 100))
        pf.close()

    def test_eof_zero_padding(self, lib, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "pf3.dada"), nsec=0.01)
        src = open_source(p)
        total = src.total_samples
        pf = PrefetchSource(open_source(p), total + 100, total + 100)
        a = pf.read_samples(0, total + 100)
        b = src.read_samples(0, total + 100)
        np.testing.assert_array_equal(a, b)
        pf.close()


class TestRing:
    def test_header_and_data_roundtrip(self, lib):
        name = f"/dspsr_jax_test_{os.getpid()}"
        obs = Observation(nchan=2, npol=2, ndim=2, nbit=8,
                          centre_frequency=1400.0, bandwidth=16.0, rate=16e6,
                          state=Signal.ANALYTIC, source="RINGTEST",
                          start_time=MJD(55000, 0.0))
        nbuf_bytes = 8192
        w = RingWriter(name, obs, nbuf_bytes, nbufs=4)
        try:
            r = RingReader(name)
            assert r.obs.source == "RINGTEST"
            assert r.obs.nchan == 2
            assert abs(r.obs.rate - 16e6) < 1

            rng = np.random.default_rng(0)
            bufs = [rng.integers(0, 256, nbuf_bytes).astype(np.uint8)
                    for _ in range(6)]

            def writer():
                for b in bufs:
                    while not w.push(b):
                        time.sleep(0.0005)
                w.set_eod()

            t = threading.Thread(target=writer)
            t.start()
            nsamp = nbuf_bytes // r.bytes_per_sample_exact()
            got = [r.read_samples(i * nsamp, nsamp) for i in range(6)]
            t.join()
            for a, b in zip(got, bufs):
                np.testing.assert_array_equal(a, b)
            with pytest.raises(EOFError):
                r.read_samples(6 * nsamp, nsamp)
            r.close()
        finally:
            w.close(unlink=True)

    def test_backpressure(self, lib):
        name = f"/dspsr_jax_bp_{os.getpid()}"
        obs = Observation(nchan=1, npol=1, ndim=1, nbit=8, rate=1e6,
                          centre_frequency=1400.0, bandwidth=1.0,
                          state=Signal.NYQUIST, start_time=MJD(55000, 0.0))
        w = RingWriter(name, obs, 64, nbufs=2)
        try:
            b = np.zeros(64, np.uint8)
            assert w.push(b) and w.push(b)
            assert not w.push(b)  # full: non-blocking refusal
        finally:
            w.close(unlink=True)


class TestLivePipeline:
    def test_fold_from_ring(self, lib, tmp_path):
        """End-to-end live mode: writer feeds ring, fold pipeline consumes."""
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
        from test_pipeline import synth_pulsar_dada, PERIOD, DM, PULSE_PHASE

        p = synth_pulsar_dada(str(tmp_path / "live.dada"), nsec=0.1)
        file_src = open_source(p)
        name = f"/dspsr_jax_live_{os.getpid()}"

        nsamp_buf = 65536
        buf_bytes = nsamp_buf * file_src.bytes_per_sample_exact()
        w = RingWriter(name, file_src.obs, buf_bytes, nbufs=8)
        try:
            r = RingReader(name)

            def feeder():
                start = 0
                while start + nsamp_buf <= file_src.total_samples:
                    buf = file_src.read_samples(start, nsamp_buf)
                    while not w.push(buf):
                        time.sleep(0.0005)
                    start += nsamp_buf
                w.set_eod()

            t = threading.Thread(target=feeder)
            t.start()

            cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=0.0,
                             coherent=False, nbin=64,
                             min_block_samples=nsamp_buf, block_parts=1)
            pipe = FoldPipeline(r, cfg)
            # force block == ring buffer granularity
            assert pipe.block_in_samples % nsamp_buf == 0 or \
                pipe.block_in_samples == nsamp_buf

            # run until the ring drains
            try:
                res = pipe.run(max_blocks=100)
            except EOFError:
                res = pipe._finish()
            t.join()
            assert res.hits.sum() > 0
            r.close()
        finally:
            w.close(unlink=True)

    def test_live_coherent_dedispersion_matches_offline(self, lib, tmp_path):
        """DM > 0 live: the ring reader carries the overlap-save tail
        host-side (Seekable.C:197-222 recycling), so the coherent pipeline
        runs on a live stream and matches the offline fold of the same
        bytes."""
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
        from test_pipeline import synth_pulsar_dada, PERIOD, DM

        p = synth_pulsar_dada(str(tmp_path / "livedm.dada"), nsec=0.15)
        file_src = open_source(p)
        name = f"/dspsr_jax_livedm_{os.getpid()}"

        nsamp_buf = 16384
        buf_bytes = nsamp_buf * file_src.bytes_per_sample_exact()
        w = RingWriter(name, file_src.obs, buf_bytes, nbufs=8)
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, nbin=32, min_block_samples=8192,
                         block_parts=2)
        try:
            r = RingReader(name)

            def feeder():
                start = 0
                while start + nsamp_buf <= file_src.total_samples:
                    buf = file_src.read_samples(start, nsamp_buf)
                    while not w.push(buf):
                        time.sleep(0.0005)
                    start += nsamp_buf
                w.set_eod()

            t = threading.Thread(target=feeder)
            t.start()

            pipe = FoldPipeline(r, cfg)
            assert pipe.nsamp_overlap > 0, "must exercise overlapping reads"
            try:
                res_live = pipe.run(max_blocks=50)
            except EOFError:
                res_live = pipe._finish()
            t.join()
            r.close()
        finally:
            w.close(unlink=True)

        # every folded output sample has weight 1 (the fold's segment
        # padding carries zero weight)
        nchan = res_live.obs.nchan
        nblocks_live = int(round(res_live.hits.sum()
                                 / (nchan * pipe.out_per_block)))
        assert nblocks_live >= 2

        off = FoldPipeline(open_source(p), cfg)
        res_off = off.run(max_blocks=nblocks_live)
        np.testing.assert_allclose(res_live.profiles, res_off.profiles,
                                   rtol=1e-6, atol=1e-3)
        np.testing.assert_allclose(res_live.hits, res_off.hits, atol=1e-3)


class TestDadaSysVRing:
    """psrdada-architecture SysV hdu (native/hostio.cpp dada_*): data block
    at key, header block at key+1, semaphore flow control — the wire the
    reference's DADABuffer attaches to (DADABuffer.C:175-208,
    dada_def.h DADA_DEFAULT_BLOCK_KEY)."""

    def _key(self):
        # per-test key away from 0xdada so parallel runs don't collide
        return 0x5A000 + (os.getpid() % 0x7FF) * 2

    def test_header_and_data_roundtrip(self, lib):
        from dspsr_jax.io.hostio import DadaWriter, DadaReader

        key = self._key()
        obs = Observation(nchan=2, npol=2, ndim=2, nbit=8,
                          centre_frequency=1400.0, bandwidth=16.0, rate=16e6,
                          state=Signal.ANALYTIC, source="DADATEST",
                          start_time=MJD(55000, 0.0))
        nbuf_bytes = 8192
        w = DadaWriter(key, obs, nbuf_bytes, nbufs=4)
        try:
            r = DadaReader(key, timeout=5.0)
            assert r.obs.source == "DADATEST"
            assert r.obs.nchan == 2

            rng = np.random.default_rng(1)
            bufs = [rng.integers(0, 256, nbuf_bytes).astype(np.uint8)
                    for _ in range(6)]

            def writer():
                for b in bufs:
                    assert w.push(b, timeout=5.0)
                w.set_eod()

            t = threading.Thread(target=writer)
            t.start()
            nsamp = nbuf_bytes // r.bytes_per_sample_exact()
            got = [r.read_samples(i * nsamp, nsamp) for i in range(6)]
            t.join()
            for a, b in zip(got, bufs):
                np.testing.assert_array_equal(a, b)
            with pytest.raises(EOFError):
                r.read_samples(6 * nsamp, nsamp)
            r.close()
        finally:
            w.close(destroy=True)

    def test_sysv_segments_at_key_conventions(self, lib):
        """The data block's sync segment lives at the hdu key and the
        header block's at key+1 — independently visible through raw SysV
        shmget (the psrdada dada_hdu convention)."""
        import ctypes
        import ctypes.util

        from dspsr_jax.io.hostio import DadaWriter

        key = self._key() + 0x1000
        obs = Observation(nchan=1, npol=1, ndim=1, nbit=8, rate=1e6,
                          centre_frequency=1400.0, bandwidth=1.0,
                          state=Signal.NYQUIST, start_time=MJD(55000, 0.0))
        w = DadaWriter(key, obs, 128, nbufs=2)
        try:
            libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
            # IPC_EXCL create must FAIL: segments already exist at key, key+1
            IPC_CREAT, IPC_EXCL = 0o1000, 0o2000
            assert libc.shmget(key, 0, 0o600) >= 0
            assert libc.shmget(key + 1, 0, 0o600) >= 0
            assert libc.shmget(key, 4096, IPC_CREAT | IPC_EXCL | 0o600) < 0
            # semaphore set exists at the data key
            assert libc.semget(key, 0, 0o600) >= 0
        finally:
            w.close(destroy=True)
        # destroyed: gone from the system
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        assert libc.shmget(key, 0, 0o600) < 0

    def test_blocking_backpressure_and_timeout(self, lib):
        from dspsr_jax.io.hostio import DadaWriter, DadaReader

        key = self._key() + 0x2000
        obs = Observation(nchan=1, npol=1, ndim=1, nbit=8, rate=1e6,
                          centre_frequency=1400.0, bandwidth=1.0,
                          state=Signal.NYQUIST, start_time=MJD(55000, 0.0))
        w = DadaWriter(key, obs, 64, nbufs=2)
        try:
            b = np.zeros(64, np.uint8)
            assert w.push(b) and w.push(b)
            t0 = time.time()
            assert not w.push(b, timeout=0.2)  # full: blocks then times out
            assert time.time() - t0 >= 0.15
            r = DadaReader(key, timeout=0.2)
            nsamp = 64
            r.read_samples(0, nsamp)  # frees a slot
            assert w.push(b, timeout=1.0)
            r.close()
        finally:
            w.close(destroy=True)

    def test_cross_process_fold(self, lib, tmp_path):
        """A separate OS process writes the SysV ring; the fold pipeline
        consumes it live (the real DAQ->pipeline topology)."""
        import subprocess
        import sys

        from dspsr_jax.io.hostio import DadaReader
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

        key = self._key() + 0x3000
        path = synth_pulsar_dada(str(tmp_path / "dd.dada"), nsec=0.08)
        buf_bytes = 16384
        code = f"""
import sys, numpy as np
sys.path.insert(0, {repr(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})
from dspsr_jax.io.hostio import DadaWriter
from dspsr_jax.io.sources import open_source
src = open_source({path!r})
w = DadaWriter({key}, src.obs, {buf_bytes}, nbufs=8)
bps = src.bytes_per_sample_exact()
n = {buf_bytes} // bps
i = 0
while (i + 1) * n <= src.total_samples:
    w.push(src.read_samples(i * n, n), timeout=30.0)
    i += 1
w.set_eod()
w.close(destroy=False)
"""
        proc = subprocess.Popen([sys.executable, "-c", code])
        try:
            r = None
            deadline = time.time() + 60.0
            while r is None:
                try:
                    r = DadaReader(key, timeout=30.0)
                except OSError:
                    if proc.poll() is not None or time.time() > deadline:
                        raise
                    time.sleep(0.25)  # writer still importing/creating
            from test_pipeline import PERIOD, DM

            cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                             nchan=4, nbin=32, block_parts=2,
                             min_block_samples=0)
            pipe = FoldPipeline(r, cfg)
            res = pipe.run(max_blocks=4)
            assert res.hits.sum() > 0
            prof = res.normalized()[0, :, 0, :]
            assert np.isfinite(prof).all()
            r.close(destroy=True)
        finally:
            assert proc.wait(timeout=60) == 0
