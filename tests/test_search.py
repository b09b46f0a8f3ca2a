"""Search-mode (digifil equivalent) tests: scrunch/rescale ops, digitizer,
SIGPROC round trip, end-to-end filterbank file creation."""

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.ops.scrunch import (
    tscrunch, fscrunch, pscrunch, poln_select, fzoom,
    update_observation_fzoom,
)
from dspsr_jax.ops.rescale import RescaleState, rescale_block, state_mean_scale
from dspsr_jax.models.load_to_fil import FilConfig, FilPipeline, digitize, load_to_fil
from dspsr_jax.io.sigproc import (
    read_sigproc_header, observation_from_sigproc, SigProcWriter,
)
from dspsr_jax.io.sources import open_source
from test_pipeline import synth_pulsar_dada, PERIOD, RATE, CF, BW, DM, PULSE_PHASE


class TestScrunch:
    def test_tscrunch_sums(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 1, 16)).astype(np.float32))
        y = np.asarray(tscrunch(x, 4))
        assert y.shape == (2, 1, 4)
        np.testing.assert_allclose(
            y, np.asarray(x).reshape(2, 1, 4, 4).sum(-1), rtol=1e-6)

    def test_fscrunch_sums(self, rng):
        x = jnp.asarray(rng.standard_normal((8, 2, 4)).astype(np.float32))
        y = np.asarray(fscrunch(x, 2))
        assert y.shape == (4, 2, 4)
        np.testing.assert_allclose(
            y, np.asarray(x).reshape(4, 2, 2, 4).sum(1), rtol=1e-6)

    def test_pscrunch(self, rng):
        x = jnp.asarray(rng.standard_normal((3, 2, 5)).astype(np.float32))
        y = np.asarray(pscrunch(x))
        np.testing.assert_allclose(y[:, 0], np.asarray(x).sum(1), rtol=1e-6)

    def test_fzoom_metadata(self):
        obs = Observation(nchan=8, centre_frequency=1400.0, bandwidth=80.0)
        out = update_observation_fzoom(obs, 2, 4)
        assert out.nchan == 4
        assert out.bandwidth == 40.0
        # channels 2..5 of 8: centres 1385,1395,1405,1415 -> cf 1400... no:
        # lower edge 1360, width 10, c2=1385, c5=1415 -> centre 1400
        assert out.centre_frequency == 1400.0


class TestRescale:
    def test_normalizes(self, rng):
        x = (rng.standard_normal((2, 2, 4096)) * 5 + 11).astype(np.float32)
        st = RescaleState.zeros(2, 2)
        st, y = rescale_block(st, jnp.asarray(x))
        y = np.asarray(y)
        assert abs(y.mean()) < 0.05
        assert abs(y.std() - 1) < 0.05

    def test_freeze(self, rng):
        x1 = rng.standard_normal((1, 1, 1024)).astype(np.float32)
        st = RescaleState.zeros(1, 1)
        st, _ = rescale_block(st, jnp.asarray(x1))
        m0, s0 = state_mean_scale(st)
        st2, _ = rescale_block(st, jnp.asarray(x1 * 100), freeze=True)
        m1, s1 = state_mean_scale(st2)
        np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))


class TestDigitizer:
    def test_8bit_roundtrip(self, rng):
        y = rng.standard_normal((4, 1, 256)).astype(np.float32)
        packed = np.asarray(digitize(jnp.asarray(y), 8, 127.5, 32.0))
        assert packed.dtype == np.uint8
        # unpack: TFP order, chan fastest
        vals = (packed.astype(np.float64) - 127.5) / 32.0
        vals = vals.reshape(256, 1, 4).transpose(2, 1, 0)
        np.testing.assert_allclose(vals, y, atol=0.5 / 32.0 + 1e-6)

    def test_2bit_packing(self):
        y = jnp.asarray(np.array([[[-5.0, -0.1, 0.1, 5.0]]], np.float32))
        packed = np.asarray(digitize(y, 2, 1.5, 1.0))
        # values -> codes 0,1,2,3 -> MSB first byte 0b00011011
        assert packed.tolist() == [0b00011011]

    def test_float32_passthrough(self, rng):
        y = rng.standard_normal((2, 1, 8)).astype(np.float32)
        packed = np.asarray(digitize(jnp.asarray(y), 32, 0.0, 1.0))
        vals = packed.view(np.float32).reshape(8, 1, 2).transpose(2, 1, 0)
        np.testing.assert_array_equal(vals, y)


class TestSigProc:
    def test_header_roundtrip(self, tmp_path):
        obs = Observation(
            nchan=32, npol=1, ndim=1, nbit=8,
            centre_frequency=1400.0, bandwidth=-64.0, rate=1e4,
            state=Signal.INTENSITY, source="TESTPSR", telescope="PKS",
        )
        p = str(tmp_path / "t.fil")
        w = SigProcWriter(p, obs, 8)
        w.write_block(np.arange(64, dtype=np.uint8))
        w.close()
        items, hdr_size = read_sigproc_header(p)
        assert items["nchans"] == 32
        assert items["nbits"] == 8
        assert items["source_name"] == "TESTPSR"
        assert items["foff"] == pytest.approx(-2.0)
        back = observation_from_sigproc(p)
        assert back.nchan == 32
        assert abs(back.centre_frequency - 1400.0) < 1e-9
        assert abs(back.bandwidth - (-64.0)) < 1e-9
        assert abs(back.rate - 1e4) < 1e-6


class TestLoadToFil:
    @pytest.fixture(scope="class")
    def psr_file(self, tmp_path_factory):
        p = tmp_path_factory.mktemp("fil") / "psr.dada"
        return synth_pulsar_dada(str(p), nsec=0.2)

    def test_end_to_end(self, psr_file, tmp_path):
        out = str(tmp_path / "out.fil")
        cfg = FilConfig(nchan=32, dispersion_measure=0.0, tscrunch_factor=4,
                        nbits=8, block_parts=4)
        obs_out = load_to_fil(psr_file, out, cfg)
        assert obs_out.nchan == 32
        items, hdr = read_sigproc_header(out)
        assert items["nchans"] == 32
        import os
        payload = os.path.getsize(out) - hdr
        nsamp = payload // 32
        assert nsamp > 0
        # pulse visible in the time series: fold the output file by the period
        data = np.fromfile(out, np.uint8, offset=hdr).reshape(nsamp, 32)
        ts = data.astype(np.float64).sum(1)
        tsamp = items["tsamp"]
        phases = ((np.arange(nsamp) * tsamp / PERIOD) % 1.0)
        on = ts[np.abs(phases - PULSE_PHASE) < 0.05].mean()
        off = ts[np.abs(phases - (PULSE_PHASE + 0.5) % 1.0) < 0.2].mean()
        assert on > off + 3 * ts.std() / np.sqrt(len(ts)), (on, off)

    def test_coherent_dedispersing_filterbank(self, psr_file, tmp_path):
        """digifil -D: chirp inside the channelizer sharpens the pulse."""
        out_c = str(tmp_path / "coh.fil")
        out_i = str(tmp_path / "inc.fil")
        cfg_c = FilConfig(nchan=16, dispersion_measure=DM, tscrunch_factor=1,
                          nbits=32, block_parts=2)
        cfg_i = FilConfig(nchan=16, dispersion_measure=0.0, tscrunch_factor=1,
                          nbits=32, block_parts=2,
                          frequency_resolution=cfg_c.frequency_resolution)
        load_to_fil(psr_file, out_c, cfg_c)
        load_to_fil(psr_file, out_i, cfg_i)

        def profile(path):
            items, hdr = read_sigproc_header(path)
            d = np.fromfile(path, np.float32, offset=hdr)
            nch = items["nchans"]
            d = d.reshape(-1, nch)
            # incoherently align channels before summing (both files equally)
            from dspsr_jax.ops.dedispersion import delay_time
            obs = observation_from_sigproc(path)
            ts = np.zeros(d.shape[0])
            tsamp = items["tsamp"]
            for c in range(nch):
                dly = delay_time(DM, obs.centre_frequency_of(c), obs.centre_frequency)
                shift = int(round(dly / tsamp))
                ts += np.roll(d[:, c], -shift)
            ph = (np.arange(len(ts)) * tsamp / PERIOD) % 1.0
            prof = np.zeros(64)
            for b in range(64):
                m = (ph >= b / 64) & (ph < (b + 1) / 64)
                prof[b] = ts[m].mean()
            return prof

        pc = profile(out_c)
        pi = profile(out_i)
        contrast_c = (pc.max() - np.median(pc)) / pc.std()
        contrast_i = (pi.max() - np.median(pi)) / pi.std()
        assert contrast_c > contrast_i, (contrast_c, contrast_i)


class TestPolyphaseChannelizer:
    def test_pfb_fil(self, tmp_path):
        src = synth_pulsar_dada(str(tmp_path / "pfb.dada"), nsec=0.05, dm=0.0)
        out = str(tmp_path / "pfb.fil")
        cfg = FilConfig(nchan=16, channelizer="polyphase", pfb_ntaps=8,
                        nbits=8, tscrunch_factor=4)
        obs = load_to_fil(src, out, cfg)
        assert obs.nchan == 16
        items, hdr = read_sigproc_header(out)
        assert items["nchans"] == 16
        import os
        assert os.path.getsize(out) > hdr

    def test_pfb_rejects_coherent(self, tmp_path):
        src = synth_pulsar_dada(str(tmp_path / "pfb2.dada"), nsec=0.01)
        with pytest.raises(ValueError):
            load_to_fil(src, "/tmp/x.fil",
                        FilConfig(nchan=8, channelizer="polyphase",
                                  dispersion_measure=1.0))


class TestChainCompleteness:
    """Round-2 digifil chain items: weights, -I interval rescale,
    PolnSelect, -K, streaming PSRFITS (LoadToFil.C:162-374,
    Rescale.C, LoadToFITS.C:135-490)."""

    def _twobit_file(self, tmp_path, nsamp=1 << 16, bad=(20000, 28000)):
        """2-bit complex dual-pol stream with a saturated (excisable)
        stretch; returns path."""
        rng = np.random.default_rng(3)
        codes = rng.choice(4, size=nsamp * 4,
                           p=[0.1615, 0.3385, 0.3385, 0.1615]).astype(np.uint8)
        c = codes.reshape(-1, 4)
        q = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
        q[bad[0]:bad[1]] = 255
        from dspsr_jax.io.dada import format_ascii_header, header_from_observation
        from dspsr_jax.timing.mjd import MJD

        obs = Observation(nchan=1, npol=2, ndim=2, nbit=2,
                          centre_frequency=CF, bandwidth=BW, rate=1e6,
                          start_time=MJD(55000, 0.1), state=Signal.ANALYTIC,
                          source="W", telescope="PKS", instrument="TB")
        p = str(tmp_path / "tb.dada")
        with open(p, "wb") as f:
            f.write(format_ascii_header(header_from_observation(obs)))
            f.write(q.tobytes())
        return p

    def test_weights_zero_bad_stretch(self, tmp_path):
        p = self._twobit_file(tmp_path)
        cfg = FilConfig(nchan=4, nbits=32, min_block_samples=8192)
        out = str(tmp_path / "w.fil")
        pipe = FilPipeline(open_source(p), cfg)
        pipe.run(out)
        hdr, data_off = read_sigproc_header(out)
        d = np.fromfile(out, np.float32, offset=data_off).reshape(-1, 4)
        # the saturated stretch maps to zeroed output samples
        assert (np.abs(d) < 1e-12).any(axis=1).sum() > 100
        # healthy samples are rescaled ~N(0,1)
        good = d[np.abs(d).sum(axis=1) > 1e-6]
        assert 0.5 < good.std() < 2.0

    def test_weights_can_be_disabled(self, tmp_path):
        p = self._twobit_file(tmp_path)
        cfg = FilConfig(nchan=4, nbits=32, min_block_samples=8192,
                        apply_weights=False)
        out = str(tmp_path / "nw.fil")
        FilPipeline(open_source(p), cfg).run(out)
        hdr, data_off = read_sigproc_header(out)
        d = np.fromfile(out, np.float32, offset=data_off).reshape(-1, 4)
        assert (np.abs(d) < 1e-12).any(axis=1).sum() < 50

    def test_rescale_interval_holds_scales(self, tmp_path):
        """-I: with a step change in level mid-stream, interval rescale
        lags (holds scales), every-block rescale tracks."""
        rng = np.random.default_rng(5)
        nsamp = 1 << 15
        x = rng.standard_normal((nsamp, 2, 2)) * 8.0
        x[nsamp // 2:] *= 4.0  # level step
        q = np.clip(np.round(x + 127.5), 0, 255).astype(np.uint8)
        from dspsr_jax.io.dada import format_ascii_header, header_from_observation
        from dspsr_jax.timing.mjd import MJD

        obs = Observation(nchan=1, npol=2, ndim=2, nbit=8,
                          centre_frequency=CF, bandwidth=BW, rate=1e6,
                          start_time=MJD(55000, 0.1), state=Signal.ANALYTIC,
                          source="I", telescope="PKS", instrument="T")
        p = str(tmp_path / "step.dada")
        with open(p, "wb") as f:
            f.write(format_ascii_header(header_from_observation(obs)))
            f.write(q.tobytes())

        def run(rescale_seconds):
            cfg = FilConfig(nchan=4, nbits=32, min_block_samples=2048,
                            block_parts=1, rescale_seconds=rescale_seconds)
            out = str(tmp_path / f"i{rescale_seconds}.fil")
            pipe = FilPipeline(open_source(p), cfg)
            pipe.run(out)
            hdr, off = read_sigproc_header(out)
            return np.fromfile(out, np.float32, offset=off).reshape(-1, 4)

        every = run(0.0)
        held = run(1.0)  # interval longer than the file: scales frozen
        n = min(len(every), len(held))
        a, b = every[:n], held[:n]
        # after the step, frozen scales leave the level jump visible
        assert b[3 * n // 4:].std() > 2.0 * a[3 * n // 4:].std()

    def test_poln_select(self, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "ps.dada"), nsec=0.05, dm=0)
        cfg = FilConfig(nchan=4, nbits=32, min_block_samples=4096,
                        poln_select=1)
        out = str(tmp_path / "ps.fil")
        pipe = FilPipeline(open_source(p), cfg)
        assert pipe.obs_out.npol == 1
        pipe.run(out)
        hdr, off = read_sigproc_header(out)
        assert int(hdr["nifs"]) == 1

    def test_interchannel_align_moves_pulse(self, tmp_path):
        """-K: channels align in time (peak at the same output sample)."""
        p = synth_pulsar_dada(str(tmp_path / "k.dada"), nsec=0.2, amp=30.0)
        outs = {}
        for tag, k in (("plain", False), ("aligned", True)):
            cfg = FilConfig(nchan=4, nbits=32, dispersion_measure=DM,
                            tscrunch_factor=4, min_block_samples=16384,
                            interchannel_align=k)
            out = str(tmp_path / f"{tag}.fil")
            FilPipeline(open_source(p), cfg).run(out)
            hdr, off = read_sigproc_header(out)
            outs[tag] = np.fromfile(out, np.float32, offset=off).reshape(-1, 4)

        def peak_spread(d):
            # fold at the pulse period and find per-channel peak phase
            tsamp = 4 * 4 / RATE
            nbin = 16
            ph = ((np.arange(len(d)) * tsamp / PERIOD) * nbin).astype(int) % nbin
            prof = np.zeros((nbin, 4))
            np.add.at(prof, ph, d)
            pk = np.argmax(prof, axis=0)
            diff = (pk[:, None] - pk[None, :]) % nbin
            diff = np.minimum(diff, nbin - diff)
            return diff.max()

        assert peak_spread(outs["aligned"]) <= peak_spread(outs["plain"])
        assert peak_spread(outs["aligned"]) <= 1

    def test_psrfits_streaming_bounded_memory(self, tmp_path):
        """Rows hit the disk as they complete; writer state stays O(row)."""
        from dspsr_jax.io.psrfits import PsrfitsSearchWriter
        from dspsr_jax.timing.mjd import MJD

        obs = Observation(nchan=8, npol=1, ndim=1, nbit=8,
                          centre_frequency=CF, bandwidth=BW, rate=1e4,
                          start_time=MJD(55000, 0.1), state=Signal.INTENSITY,
                          source="S", telescope="PKS", instrument="T")
        path = str(tmp_path / "soak.sf")
        w = PsrfitsSearchWriter(path, obs, nbits=8, nsblk=1024)
        import os as _os

        block = np.zeros(8 * 1024, np.uint8)  # exactly one row per block
        sizes = []
        for i in range(64):
            w.write_block(block)
            if i % 16 == 15:
                w._f.flush()
                sizes.append(_os.path.getsize(path))
        assert sizes[-1] > sizes[0]  # rows stream out incrementally
        assert w._carry.size == 0
        w.close()
        from dspsr_jax.io.fits import read_fits_headers

        hdus = read_fits_headers(path)
        sub = [h for h in hdus if h.get("EXTNAME", "").strip("' ") == "SUBINT"][0]
        assert int(sub["NAXIS2"]) == 64


def _search_golden_block(pipe, raw):
    """First search-mode block through the float64 model: golden unpack +
    filterbank + intensity, then the first-block Rescale (block mean and
    standard deviation) and the 8-bit SIGPROC digitizer, TFP order."""
    from types import SimpleNamespace
    from dspsr_jax import golden
    from dspsr_jax.observation import Signal

    resp = pipe._response_natural
    kernel = (SimpleNamespace(phasors=np.asarray(resp[0])
                              + 1j * np.asarray(resp[1]))
              if resp is not None else None)
    view = SimpleNamespace(
        obs_in=pipe.obs_in, unpack_plan=pipe.unpack_plan,
        obs_out=pipe.obs_out, fb_plan=pipe.fb_plan, conv_plan=None,
        npart=pipe.npart, kernel=kernel, jones_response=None,
        config=SimpleNamespace(fft_window=None, passband=False,
                               rfi_filter=False))
    x, _ = golden.unpack(view, raw)
    y, _ = golden.channelize(view, x)
    d = golden.detect(y, Signal.INTENSITY)  # [nchan, 1, ndat]
    mean = d.mean(axis=-1, keepdims=True)
    std = d.std(axis=-1, keepdims=True)
    q = np.clip(np.round((d - mean) / std * 32.0 + 127.5), 0, 255)
    return q.transpose(2, 1, 0).reshape(-1).astype(np.uint8)


SEARCH_CASES = {
    # multi-channel complex 8-bit (GUPPI shape), coherent filterbank
    "multichan_coherent": (dict(nchan=2, nbit=8, ndim=2),
                           dict(nchan=8, dispersion_measure=4.0,
                                frequency_resolution=512)),
    # fixed-level 2-bit complex, incoherent filterbank
    "fixed_twobit": (dict(nchan=1, nbit=2, ndim=2),
                     dict(nchan=32, dispersion_measure=0.0,
                          dynamic_twobit=False, frequency_resolution=1024)),
    "real_8bit": (dict(nchan=1, nbit=8, ndim=1),
                  dict(nchan=16, dispersion_measure=2.0)),
    "twos_4bit": (dict(nchan=1, nbit=4, ndim=2),
                  dict(nchan=8, dispersion_measure=0.0,
                       twos_complement=True)),
}


class TestSearchGolden:
    @pytest.mark.parametrize("case", sorted(SEARCH_CASES))
    def test_first_block_matches_golden(self, tmp_path, case):
        """digifil's first requantized block equals the float64 model's
        (filterbank, detection, rescale, 8-bit digitizer) to within one
        count of rounding."""
        from dspsr_jax.io.sources import RawFileSource
        from dspsr_jax.io.sigproc import read_sigproc_header
        from dspsr_jax.models.load_to_fil import FilConfig, FilPipeline
        from dspsr_jax.timing.mjd import MJD

        obskw, cfgkw = SEARCH_CASES[case]
        rng = np.random.default_rng(17)
        obs = Observation(
            npol=2, centre_frequency=1400.0, bandwidth=-4.0,
            rate=(1e6 if obskw["ndim"] == 2 else 2e6) / obskw["nchan"],
            start_time=MJD.from_utc("2010-04-13-02:05:45"),
            state=Signal.ANALYTIC if obskw["ndim"] == 2 else Signal.NYQUIST,
            source="FAKE", telescope="PKS", instrument="RAW", **obskw)
        raw = rng.integers(0, 256, 1 << 17).astype(np.uint8)
        p = str(tmp_path / "s.raw")
        raw.tofile(p)
        cfg = FilConfig(nbits=8, block_parts=2, min_block_samples=8192,
                        **cfgkw)
        pipe = FilPipeline(RawFileSource(p, obs), cfg)
        out = str(tmp_path / "s.fil")
        pipe.run(out, max_blocks=1)
        _, hdr = read_sigproc_header(out)
        got = np.fromfile(out, np.uint8, offset=hdr)
        block = raw[: int(pipe.block_in_samples * obs.nbytes_per_sample)]
        want = _search_golden_block(pipe, block)
        assert got.size == want.size > 0
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff == 0).mean() > 0.99
