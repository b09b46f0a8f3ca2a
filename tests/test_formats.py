"""VDIF and GUPPI RAW format reader tests (synthetic files)."""

import struct

import numpy as np
import pytest

from dspsr_jax.io import open_source
from dspsr_jax.io.vdif import VDIFFile, parse_vdif_header, _epoch_to_mjd
from dspsr_jax.io.guppi import GuppiRawFile
from dspsr_jax.observation import Signal


def make_vdif(path, nframes=32, payload=1024, nchan=1, nbit=8, cplx=True,
              frames_per_sec=8, ref_epoch=20, seconds=1234):
    """Write a synthetic single-thread VDIF file; returns payload bytes."""
    rng = np.random.default_rng(0)
    frame_bytes = payload + 32
    data = rng.integers(0, 256, nframes * payload).astype(np.uint8)
    with open(path, "wb") as f:
        for i in range(nframes):
            sec = seconds + (i // frames_per_sec)
            frm = i % frames_per_sec
            w0 = sec & 0x3FFFFFFF
            w1 = (frm & 0xFFFFFF) | (ref_epoch << 24)
            w2 = (frame_bytes // 8) | (int(np.log2(nchan)) << 24)
            w3 = ((nbit - 1) << 26) | ((1 if cplx else 0) << 31)
            f.write(struct.pack("<4I", w0, w1, w2, w3))
            f.write(struct.pack("<4I", 0, 0, 0, 0))  # extended words
            f.write(data[i * payload : (i + 1) * payload].tobytes())
    return data


class TestVDIF:
    def test_probe_and_geometry(self, tmp_path):
        p = str(tmp_path / "t.vdif")
        data = make_vdif(p)
        src = open_source(p)
        assert isinstance(src, VDIFFile)
        o = src.obs
        assert o.nchan == 1 and o.ndim == 2 and o.nbit == 8
        assert o.state == Signal.ANALYTIC
        # payload 1024 B, 2 B/sample -> 512 samples/frame; 8 frames/s
        assert src.samples_per_frame == 512
        assert o.rate == 512 * 8
        assert src.total_samples == 32 * 512

    def test_read_matches_payload(self, tmp_path):
        p = str(tmp_path / "t2.vdif")
        data = make_vdif(p)
        src = open_source(p)
        a = src.read_samples(0, 512)
        np.testing.assert_array_equal(a, data[:1024])
        # crossing a frame boundary
        b = src.read_samples(500, 24)
        np.testing.assert_array_equal(b, data[1000:1048])

    def test_start_time(self, tmp_path):
        p = str(tmp_path / "t3.vdif")
        make_vdif(p, ref_epoch=20, seconds=1234)
        src = open_source(p)
        # epoch 20 = 2010-01-01
        assert src.obs.start_time.days == _epoch_to_mjd(20)
        assert abs(src.obs.start_time.secs - 1234.0) < 1e-6

    def test_sidecar_header(self, tmp_path):
        p = str(tmp_path / "t4.vdif")
        make_vdif(p, nchan=2)
        with open(p + ".hdr", "w") as f:
            f.write("FREQ 1400.0\nBW 32.0\nNPOL 2\nSOURCE J0000+0000\n")
        src = open_source(p)
        assert src.obs.centre_frequency == 1400.0
        assert src.obs.npol == 2 and src.obs.nchan == 1


def make_guppi(path, nblocks=3, ntime=256, nchan=4, directio=0):
    rng = np.random.default_rng(1)
    per = nchan * 4  # 2 pol complex int8
    blocsize = ntime * per
    blocks = []
    with open(path, "wb") as f:
        for b in range(nblocks):
            cards = [
                f"BLOCSIZE= {blocsize}",
                f"OBSNCHAN= {nchan}",
                "NPOL    = 4",
                "NBITS   = 8",
                "TBIN    = 1e-06",
                "OBSFREQ = 1500.0",
                "OBSBW   = 4.0",
                "STT_IMJD= 55000",
                "STT_SMJD= 100",
                "SRC_NAME= 'FAKE'",
                f"DIRECTIO= {directio}",
            ]
            for c in cards:
                f.write(c.ljust(80).encode())
            f.write(b"END".ljust(80))
            if directio:
                f.write(b"\0" * ((-f.tell()) % 512))
            data = rng.integers(0, 256, (nchan, ntime * 4)).astype(np.uint8)
            blocks.append(data)
            f.write(data.tobytes())
            if directio:
                f.write(b"\0" * ((-blocsize) % 512))
    return blocks


class TestGuppi:
    @pytest.mark.parametrize("directio", [0, 1])
    def test_probe_and_read(self, tmp_path, directio):
        p = str(tmp_path / f"g{directio}.raw")
        blocks = make_guppi(p, directio=directio)
        src = open_source(p)
        assert isinstance(src, GuppiRawFile)
        o = src.obs
        assert o.nchan == 4 and o.npol == 2 and o.ndim == 2 and o.nbit == 8
        assert src.block_ntime == 256
        assert src.total_samples == 3 * 256

        # TFP transpose check: sample t, chan c -> block data[c, t*4:(t+1)*4]
        a = src.read_samples(0, 10).reshape(10, 4, 4)
        for t in range(10):
            for c in range(4):
                np.testing.assert_array_equal(
                    a[t, c], blocks[0][c, t * 4 : (t + 1) * 4])

    def test_cross_block_read(self, tmp_path):
        p = str(tmp_path / "g2.raw")
        blocks = make_guppi(p)
        src = open_source(p)
        a = src.read_samples(250, 12).reshape(12, 4, 4)
        for i in range(12):
            t = 250 + i
            blk, wt = divmod(t, 256)
            for c in range(4):
                np.testing.assert_array_equal(
                    a[i, c], blocks[blk][c, wt * 4 : (wt + 1) * 4])

    def test_fold_guppi_pipeline(self, tmp_path):
        """GUPPI file flows through the fold pipeline (twos-complement)."""
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
        p = str(tmp_path / "g3.raw")
        make_guppi(p, nblocks=8, ntime=4096, nchan=2)
        src = open_source(p)
        cfg = FoldConfig(folding_period=0.001, coherent=False, nbin=16,
                         twos_complement=True, min_block_samples=4096,
                         block_parts=1)
        res = FoldPipeline(src, cfg).run()
        assert res.hits.sum() > 0
        assert res.obs.nchan == 2


class TestMultiplex:
    def _mkdada(self, path, payload: bytes):
        hdr = ("HDR_VERSION 1.0\nHDR_SIZE 4096\nBW 1.0\nFREQ 1400.0\n"
               "NCHAN 1\nNPOL 1\nNDIM 1\nNBIT 8\nTSAMP 1.0\n"
               "UTC_START 2010-04-13-02:05:45\nOBS_OFFSET 0\nSOURCE MUX\n"
               "TELESCOPE PKS\nINSTRUMENT TEST\n").encode()
        with open(path, "wb") as f:
            f.write(hdr + b"\0" * (4096 - len(hdr)))
            f.write(payload)

    def test_packet_interleave(self, tmp_path):
        from dspsr_jax.io.sources import Multiplex
        P = Multiplex.PACKET
        a = str(tmp_path / "a.dada")
        b = str(tmp_path / "b.dada")
        # 2.5 packets in A, 3 in B -> 2 whole packets each usable
        self._mkdada(a, bytes([0xAA]) * (P * 2 + P // 2))
        self._mkdada(b, bytes([0xBB]) * (P * 3))
        mux = Multiplex([a, b])
        assert mux.total_samples == 2 * 2 * P
        s = mux.read_samples(0, 4 * P)
        assert set(s[:P]) == {0xAA}
        assert set(s[P:2 * P]) == {0xBB}
        assert set(s[2 * P:3 * P]) == {0xAA}
        assert set(s[3 * P:]) == {0xBB}
        # unaligned read across a packet boundary
        t = mux.read_samples(P - 5, 10)
        assert list(t) == [0xAA] * 5 + [0xBB] * 5

    def test_list_file_probe(self, tmp_path):
        from dspsr_jax.io.sources import Multiplex, open_source
        P = Multiplex.PACKET
        a = str(tmp_path / "a.dada")
        b = str(tmp_path / "b.dada")
        self._mkdada(a, bytes([1]) * P)
        self._mkdada(b, bytes([2]) * P)
        lst = str(tmp_path / "files.mux")
        with open(lst, "w") as f:
            f.write(a + "\n" + b + "\n")
        assert Multiplex.is_valid(lst)
        src = open_source(lst)
        assert isinstance(src, Multiplex)
        assert src.total_samples == 2 * P


class TestBlockFileAndPresto:
    def test_blockfile_skips_per_block_headers(self, tmp_path):
        """Generic BlockFile: payload reassembled across framed blocks
        (Kernel/Classes/BlockFile.C)."""
        from dspsr_jax.io.sources import BlockFileSource
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD

        rng = np.random.default_rng(0)
        payload = rng.integers(0, 256, 1000).astype(np.uint8)
        bh, bt, pl = 16, 8, 100
        p = str(tmp_path / "blk.dat")
        with open(p, "wb") as f:
            for i in range(0, 1000, pl):
                f.write(b"H" * bh)
                f.write(payload[i:i + pl].tobytes())
                f.write(b"T" * bt)
        obs = Observation(nchan=1, npol=1, ndim=1, nbit=8,
                          centre_frequency=1400.0, bandwidth=1.0, rate=1e6,
                          start_time=MJD(55000, 0.0),
                          state=Signal.NYQUIST)
        src = BlockFileSource(p, obs, block_bytes=bh + pl + bt,
                              block_header_bytes=bh, block_trailer_bytes=bt)
        assert src.total_samples == 1000
        np.testing.assert_array_equal(src.read_samples(0, 1000), payload)
        # unaligned read crossing block boundaries
        np.testing.assert_array_equal(src.read_samples(37, 250),
                                      payload[37:287])

    def test_presto_inf(self, tmp_path):
        from dspsr_jax.io.sources import observation_from_presto_inf

        p = str(tmp_path / "x.inf")
        with open(p, "w") as f:
            f.write(""" Data file name without suffix          =  fake
 Telescope used                         =  Parkes
 Instrument used                        =  Multibeam
 Object being observed                  =  J0835-4510
 Epoch of observation (MJD)             =  55299.08731
 Number of bins in the time series      =  1000
 Width of each time series bin (sec)    =  6.4e-05
 Dispersion measure (cm-3 pc)           =  67.99
 Central freq of low channel (MHz)      =  1182.0
 Total bandwidth (MHz)                  =  400
 Number of channels                     =  128
 Channel bandwidth (MHz)                =  3.125
""")
        obs = observation_from_presto_inf(p)
        assert obs.nchan == 128
        assert obs.telescope == "Parkes"
        assert abs(obs.rate - 1 / 6.4e-05) < 1e-6
        assert abs(obs.dispersion_measure - 67.99) < 1e-9
        assert abs(obs.centre_frequency - (1182.0 + 0.5 * 3.125 * 127)) < 1e-6


class TestPolnReshape:
    def test_coherence_stokes_roundtrip(self):
        import jax.numpy as jnp
        from dspsr_jax.ops.scrunch import poln_reshape
        from dspsr_jax.observation import Signal

        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((3, 4, 8)).astype(np.float32))
        s = poln_reshape(x, Signal.COHERENCE, Signal.STOKES)
        back = poln_reshape(s, Signal.STOKES, Signal.COHERENCE)
        np.testing.assert_allclose(np.asarray(back), np.asarray(x),
                                   rtol=1e-6, atol=1e-6)
        i = poln_reshape(x, Signal.COHERENCE, Signal.INTENSITY)
        np.testing.assert_allclose(np.asarray(i)[:, 0],
                                   np.asarray(x)[:, 0] + np.asarray(x)[:, 1],
                                   rtol=1e-6)


def make_vdif_multithread(path, nthread=2, nframes_per_thread=16,
                          payload=1024, nbit=8, cplx=True,
                          frames_per_sec=8, ref_epoch=20, seconds=1234):
    """Round-robin multi-thread VDIF (thread IDs 0..nthread-1, frame
    counters PER THREAD); returns {thread: payload bytes}."""
    rng = np.random.default_rng(3)
    frame_bytes = payload + 32
    data = {t: rng.integers(0, 256, nframes_per_thread * payload)
            .astype(np.uint8) for t in range(nthread)}
    with open(path, "wb") as f:
        for j in range(nframes_per_thread):
            for t in range(nthread):
                sec = seconds + (j // frames_per_sec)
                frm = j % frames_per_sec
                w0 = sec & 0x3FFFFFFF
                w1 = (frm & 0xFFFFFF) | (ref_epoch << 24)
                w2 = (frame_bytes // 8)
                w3 = (t << 16) | ((nbit - 1) << 26) | ((1 if cplx else 0) << 31)
                f.write(struct.pack("<4I", w0, w1, w2, w3))
                f.write(struct.pack("<4I", 0, 0, 0, 0))
                f.write(data[t][j * payload : (j + 1) * payload].tobytes())
    return data


class TestVDIFMultiThread:
    def test_two_threads_are_pols(self, tmp_path):
        p = str(tmp_path / "mt.vdif")
        data = make_vdif_multithread(p, nthread=2)
        src = open_source(p)
        assert isinstance(src, VDIFFile)
        o = src.obs
        assert src.nthread == 2 and o.npol == 2 and o.nchan == 1
        assert o.ndim == 2 and o.nbit == 8
        # per-thread rate unchanged: 512 samples/frame, 8 frames/s
        assert o.rate == 512 * 8
        assert src.total_samples == 16 * 512
        # TFP interleave: sample s = [p0 re, p0 im, p1 re, p1 im]
        got = src.read_samples(0, 4)
        exp = np.empty(16, np.uint8)
        for s in range(4):
            exp[4 * s + 0 : 4 * s + 2] = data[0][2 * s : 2 * s + 2]
            exp[4 * s + 2 : 4 * s + 4] = data[1][2 * s : 2 * s + 2]
        np.testing.assert_array_equal(got, exp)
        # frame-boundary crossing reads stay consistent
        a = src.read_samples(500, 24)
        b = src.read_samples(0, 524)[500 * 4 :]
        np.testing.assert_array_equal(a, b)

    def test_two_bit_threads_repack(self, tmp_path):
        from dspsr_jax.unpack.unpackers import bytes_to_codes
        import jax.numpy as jnp

        p = str(tmp_path / "mt2.vdif")
        data = make_vdif_multithread(p, nthread=2, nbit=2, payload=512)
        src = open_source(p)
        o = src.obs
        assert o.nbit == 2 and o.npol == 2 and o.ndim == 2
        nsamp = 64
        got = np.asarray(bytes_to_codes(
            jnp.asarray(src.read_samples(0, nsamp)), 2)).reshape(nsamp, 2, 2)
        for t in (0, 1):
            codes_t = np.asarray(bytes_to_codes(
                jnp.asarray(data[t][: nsamp]), 2)).reshape(-1, 2)[: nsamp]
            np.testing.assert_array_equal(got[:, t, :], codes_t)

    def test_four_threads_are_channels(self, tmp_path):
        p = str(tmp_path / "mt4.vdif")
        make_vdif_multithread(p, nthread=4)
        src = open_source(p)
        assert src.obs.nchan == 4 and src.obs.npol == 1

    def test_irregular_interleave_rejected(self, tmp_path):
        p = str(tmp_path / "bad.vdif")
        make_vdif_multithread(p, nthread=2)
        # corrupt one frame's thread id to break the round-robin
        import os
        with open(p, "r+b") as f:
            f.seek(3 * (1024 + 32) + 12)
            w3 = struct.unpack("<I", f.read(4))[0]
            f.seek(3 * (1024 + 32) + 12)
            f.write(struct.pack("<I", (w3 & ~0x03FF0000) | (5 << 16)))
        with pytest.raises(ValueError):
            open_source(p)

    def test_multithread_folds_end_to_end(self, tmp_path):
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

        p = str(tmp_path / "mtf.vdif")
        make_vdif_multithread(p, nthread=2, nframes_per_thread=64)
        with open(p + ".hdr", "w") as f:
            f.write("FREQ 1400\nBW -2\nTELESCOPE PKS\nSOURCE FAKE\n")
        src = open_source(p)
        pipe = FoldPipeline(src, FoldConfig(
            folding_period=0.004, dispersion_measure=1.0, nchan=4, nbin=16,
            block_parts=2, min_block_samples=0, digitizer_stats=False))
        res = pipe.run()
        assert np.isfinite(np.asarray(res.profiles)).all()
        assert np.asarray(res.hits).sum() > 0


# ---- Mark5B (round 4) ----


def _bcd_enc(value, digits):
    out = 0
    for d in range(digits):
        out |= (value % 10) << (4 * d)
        value //= 10
    return out


def make_mark5b(path, nframes=16, frames_per_sec=4, mjd=58100, sec=4321,
                seed=0, start_frame=0, bcd_frac=True):
    """Synthetic Mark5B stream; returns the payload bytes.

    ``start_frame``: the within-second frame number of the first frame
    (a recording that started mid-second).  ``bcd_frac``: also encode the
    within-second offset in the BCD '.SSSS' field, as VLBA-capable
    recorders do — the reader must NOT add it on top of the frame-counter
    offset.
    """
    from dspsr_jax.io.mark5b import FRAME_BYTES, HEADER_BYTES, MARK5B_SYNC

    rng = np.random.default_rng(seed)
    payload = FRAME_BYTES - HEADER_BYTES
    data = rng.integers(0, 256, nframes * payload).astype(np.uint8)
    with open(path, "wb") as f:
        for i in range(nframes):
            s = sec + (start_frame + i) // frames_per_sec
            frm = (start_frame + i) % frames_per_sec
            w0 = MARK5B_SYNC
            w1 = frm & 0x7FFF
            w2 = (_bcd_enc(mjd % 1000, 3) << 20) | _bcd_enc(s, 5)
            frac = int(round(frm / frames_per_sec * 1e4)) if bcd_frac else 0
            w3 = _bcd_enc(frac, 4) << 16
            f.write(struct.pack("<4I", w0, w1, w2, w3))
            f.write(data[i * payload : (i + 1) * payload].tobytes())
    return data


class TestMark5B:
    def test_probe_geometry_time(self, tmp_path):
        from dspsr_jax.io.mark5b import Mark5BFile

        p = str(tmp_path / "t.m5b")
        make_mark5b(p)
        src = open_source(p)
        assert isinstance(src, Mark5BFile)
        o = src.obs
        # default mode: 2-bit real single-channel single-pol
        assert o.nbit == 2 and o.nchan == 1 and o.ndim == 1
        # 10000 B payload * 4 samples/B = 40000 samples/frame; 4 frames/s
        assert src.samples_per_frame == 40000
        assert o.rate == 160000.0
        # truncated MJD 100 resolves near the default 58000 reference
        assert o.start_time.days == 58100
        assert abs(o.start_time.secs - 4321.0) < 1e-6

    def test_midsecond_start_no_double_count(self, tmp_path):
        """A recording starting at frame 2/4 with the SAME offset in the
        BCD '.SSSS' field: start time is sec + 0.5 exactly (the frame
        counter), not sec + 1.0 (ADVICE r4: double-counted offset)."""
        p = str(tmp_path / "mid.m5b")
        make_mark5b(p, nframes=16, start_frame=2, bcd_frac=True)
        src = open_source(p)
        assert abs(src.obs.start_time.secs - 4321.5) < 1e-9

    def test_short_stream_requires_sidecar_rate(self, tmp_path):
        """No second rollover in the scan -> frames/sec is unknowable
        from the counter; the reader must fail loudly unless the sidecar
        provides FPS or SAMPLE_RATE (ADVICE r4)."""
        import pytest
        from dspsr_jax.io.mark5b import Mark5BFile

        p = str(tmp_path / "short.m5b")
        make_mark5b(p, nframes=3, frames_per_sec=4)  # all in one second
        with pytest.raises(ValueError, match="shorter than one"):
            Mark5BFile(p)
        with open(p + ".hdr", "w") as f:
            f.write("FPS 4\n")
        src = Mark5BFile(p)
        assert src.obs.rate == 4 * 40000
        # SAMPLE_RATE in Hz works too
        p2 = str(tmp_path / "short2.m5b")
        make_mark5b(p2, nframes=3, frames_per_sec=4)
        with open(p2 + ".hdr", "w") as f:
            f.write("SAMPLE_RATE 160000\n")
        assert Mark5BFile(p2).obs.rate == 160000.0

    def test_read_crosses_frames(self, tmp_path):
        p = str(tmp_path / "t2.m5b")
        data = make_mark5b(p)
        src = open_source(p)
        # 4 samples/byte: samples [39996, 40020) span the frame boundary
        b = src.read_samples(39996, 24)
        np.testing.assert_array_equal(b[:1], data[9999:10000])
        np.testing.assert_array_equal(b[1:], data[10000:10005])

    def test_sidecar_and_fold(self, tmp_path):
        """Sidecar geometry applies, and the 2-bit stream folds through
        the pipeline with FIXED 2-bit levels (MARK5B instrument default:
        no JA98 dynamic correction)."""
        from dspsr_jax.models.load_to_fold import FoldPipeline, FoldConfig

        p = str(tmp_path / "t3.m5b")
        make_mark5b(p, nframes=32)
        with open(p + ".hdr", "w") as f:
            f.write("NPOL 2\nNDIM 2\nFREQ 1400.0\nBW -0.02\n"
                    "SOURCE J0000+0000\nTELESCOPE PKS\n")
        src = open_source(p)
        assert src.obs.npol == 2 and src.obs.ndim == 2
        assert src.samples_per_frame == 10000
        cfg = FoldConfig(folding_period=0.005, dispersion_measure=0.0,
                         nchan=4, nbin=16, block_parts=2,
                         min_block_samples=8192, digitizer_stats=False,
                         frequency_resolution=1024)
        pipe = FoldPipeline(src, cfg)
        assert pipe.unpack_plan.twobit is None  # fixed-level (mark5access)
        res = pipe.run()
        assert np.asarray(res.hits).sum() > 0
