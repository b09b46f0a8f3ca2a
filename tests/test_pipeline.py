"""End-to-end fold pipeline tests (M1 milestone, SURVEY.md §7.5).

Synthesize DADA files containing a dispersed periodic pulse in 8-bit
baseband, run the full load->unpack->dedisperse->detect->fold pipeline, and
check the folded profile: pulse at the right phase, correct metadata, archive
round trip.
"""

import dataclasses
import os

import numpy as np
import pytest

from dspsr_jax.io.dada import format_ascii_header
from dspsr_jax.io.sources import open_source, DADAFile, DummySource, MultiFile
from dspsr_jax.io.archive import save_archive, load_archive, filename_epoch
from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline, load_to_fold
from dspsr_jax.observation import Signal
from dspsr_jax.ops.dedispersion import Dedispersion


PULSE_PHASE = 0.3
PERIOD = 0.005  # 5 ms
RATE = 4e6  # complex samp/s
CF, BW = 1400.0, 4.0  # MHz
# smear across the band ~ 8.3us * DM * BW / f_GHz^3 = 1.8 ms (0.36 turns):
# coherent dedispersion visibly matters, incoherent folding smears the pulse
DM = 150.0


def synth_pulsar_dada(path, nsec=0.5, nbit=8, npol=2, dm=DM, seed=1, amp=8.0):
    """Write a DADA file with a dispersed pulsar in complex baseband."""
    rng = np.random.default_rng(seed)
    ndat = int(nsec * RATE)
    t = np.arange(ndat) / RATE
    phase = (t / PERIOD) % 1.0
    env = 1.0 + amp * np.exp(-0.5 * ((phase - PULSE_PHASE) / 0.02) ** 2)
    x = (rng.standard_normal((npol, ndat)) + 1j * rng.standard_normal((npol, ndat)))
    x *= env[None, :]

    if dm > 0:
        ded = Dedispersion.build(dm, CF, BW, 1, ndat, zap_dc=False)
        spec = np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1)
        spec *= np.conj(ded.phasors[0])[None, :]
        x = np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1)

    # quantize to 8-bit offset binary, TFP order (t, pol, dim)
    scale = 10.0 / np.std(x.real)
    tfp = np.empty((ndat, npol, 2), np.float64)
    tfp[:, :, 0] = x.real.T * scale
    tfp[:, :, 1] = x.imag.T * scale
    q = np.clip(np.round(tfp + 127.5 - 0.5), 0, 255).astype(np.uint8)

    hdr = {
        "HDR_VERSION": "1.0",
        "HDR_SIZE": "4096",
        "TELESCOPE": "TEST",
        "INSTRUMENT": "SYNTH",
        "SOURCE": "FAKEPSR",
        "MODE": "PSR",
        "FREQ": repr(CF),
        "BW": repr(BW),
        "NCHAN": "1",
        "NPOL": str(npol),
        "NDIM": "2",
        "NBIT": str(nbit),
        "TSAMP": repr(1e6 / RATE),
        "UTC_START": "2010-04-13-02:05:45",
        "OBS_OFFSET": "0",
    }
    with open(path, "wb") as f:
        f.write(format_ascii_header(hdr))
        f.write(q.tobytes())
    return path


@pytest.fixture(scope="module")
def pulsar_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "fake_pulsar.dada"
    return synth_pulsar_dada(str(p))


class TestSources:
    def test_open_dada(self, pulsar_file):
        src = open_source(pulsar_file)
        assert isinstance(src, DADAFile)
        assert src.obs.npol == 2 and src.obs.ndim == 2
        assert src.obs.state == Signal.ANALYTIC
        assert src.total_samples == int(0.5 * RATE)

    def test_read_past_eod_zero_padded(self, pulsar_file):
        src = open_source(pulsar_file)
        raw = src.read_samples(src.total_samples - 10, 100)
        bps = src.bytes_per_sample_exact()
        assert len(raw) == 100 * bps
        assert not raw[: 10 * bps].sum() == 0  # real data present
        assert raw[10 * bps :].sum() == 0  # padded

    def test_dummy_source(self):
        src = open_source("/root/reference/Benchmark/header.dada")
        assert isinstance(src, DummySource)
        assert src.obs.npol == 2
        a = src.read_samples(0, 1000)
        b = src.read_samples(0, 1000)
        np.testing.assert_array_equal(a, b)  # deterministic
        c = src.read_samples(500, 500)
        np.testing.assert_array_equal(a[500 * 2 :], c)  # position-consistent

    def test_multifile(self, tmp_path):
        p1 = synth_pulsar_dada(str(tmp_path / "a.dada"), nsec=0.01)
        # contiguity requires matching start_time + duration; just force it
        p2 = synth_pulsar_dada(str(tmp_path / "b.dada"), nsec=0.01)
        m = MultiFile([p1, p2], force_contiguity=True)
        assert m.total_samples == 2 * int(0.01 * RATE)
        bps = m.bytes_per_sample_exact()
        a = m.read_samples(int(0.01 * RATE) - 5, 10)
        s2 = open_source(p2)
        np.testing.assert_array_equal(a[5 * bps :], s2.read_samples(0, 5))


class TestFoldPipeline:
    def test_coherent_fold_recovers_pulse(self, pulsar_file):
        cfg = FoldConfig(
            folding_period=PERIOD,
            dispersion_measure=DM,
            npol_out=1,
            block_parts=2,
        )
        res = load_to_fold(pulsar_file, cfg)
        assert res.profiles.shape[0] == 1  # one subint
        prof = res.normalized()[0, 0, 0]
        peak = prof.argmax() / res.nbin
        assert abs(peak - PULSE_PHASE) < 0.03, peak
        snr = (prof.max() - np.median(prof)) / (np.std(prof) + 1e-30)
        assert snr > 3

    def test_dispersion_matters(self, pulsar_file):
        """Folding without dedispersion must smear the pulse (lower peak)."""
        cfg_coh = FoldConfig(folding_period=PERIOD, dispersion_measure=DM)
        cfg_inc = FoldConfig(folding_period=PERIOD, dispersion_measure=0.0,
                             coherent=False)
        res_c = load_to_fold(pulsar_file, cfg_coh)
        res_i = load_to_fold(pulsar_file, cfg_inc)
        pc = res_c.normalized()[0, 0, 0]
        pi = res_i.normalized()[0, 0, 0]
        contrast_c = pc.max() / np.median(pc)
        contrast_i = pi.max() / np.median(pi)
        # 1.8 ms smear vs 5 ms period: strong contrast loss when incoherent
        assert contrast_c > contrast_i * 1.5, (contrast_c, contrast_i)

    def test_ppqq_detection(self, pulsar_file):
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         npol_out=2, block_parts=2)
        res = load_to_fold(pulsar_file, cfg)
        assert res.obs.npol == 2
        # both pols carry the pulse
        for p in range(2):
            prof = res.normalized()[0, 0, p]
            assert abs(prof.argmax() / res.nbin - PULSE_PHASE) < 0.03

    def test_filterbank_fold(self, pulsar_file):
        """Convolving filterbank path: 4 channels, pulse in every channel."""
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2)
        res = load_to_fold(pulsar_file, cfg)
        assert res.obs.nchan == 4
        # per-channel profiles retain inter-channel dispersion delay (as in
        # reference archives); each channel peaks at phase0 + delay(f_c)/P
        raw = res.normalized()[0]
        from dspsr_jax.ops.dedispersion import delay_time
        for c in range(4):
            dphi = delay_time(DM, res.obs.centre_frequency_of(c), CF) / PERIOD
            expect = (PULSE_PHASE + dphi) % 1.0
            peak = raw[c, 0].argmax() / res.nbin
            err = min(abs(peak - expect), 1 - abs(peak - expect))
            assert err < 0.05, (c, peak, expect)
        # archive-domain dedispersion aligns all channels at PULSE_PHASE
        prof = res.dedispersed()[0]  # [nchan, npol, nbin]
        for c in range(4):
            peak = prof[c, 0].argmax() / res.nbin
            assert abs(peak - PULSE_PHASE) < 0.05, (c, peak)

    def test_subints(self, pulsar_file):
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         subint_seconds=0.1, block_parts=2)
        res = load_to_fold(pulsar_file, cfg)
        assert res.profiles.shape[0] >= 3
        # every subint shows the pulse at the same phase
        for s in range(res.profiles.shape[0]):
            prof = res.normalized()[s, 0, 0]
            assert abs(prof.argmax() / res.nbin - PULSE_PHASE) < 0.05

    def test_total_seconds_limit(self, pulsar_file):
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         block_parts=2)
        res = load_to_fold(pulsar_file, cfg, total_seconds=0.2)
        assert float(np.sum(res.integration_length)) <= 0.21


class TestArchive:
    def test_roundtrip(self, pulsar_file, tmp_path):
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         block_parts=2)
        res = load_to_fold(pulsar_file, cfg)
        path = str(tmp_path / filename_epoch(res))
        save_archive(path, res)
        back = load_archive(path)
        np.testing.assert_allclose(back["profiles"], res.profiles)
        np.testing.assert_allclose(back["hits"], res.hits)
        assert back["meta"]["source"] == "FAKEPSR"
        assert back["meta"]["nbin"] == res.nbin


class TestInterchannelAlign:
    def test_channels_align_to_highest_frequency(self, pulsar_file):
        """-K equivalent: the delay ramp in the chirp aligns all channels to
        the arrival time at the highest frequency in the band."""
        from dspsr_jax.ops.dedispersion import delay_time

        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, interchannel_align=True)
        res = load_to_fold(pulsar_file, cfg)
        raw = res.normalized()[0]
        # expected common phase: arrival at the highest channel centre
        # (synth dispersed the pulse relative to the band centre CF)
        f_high = max(res.obs.centre_frequency_of(c) for c in range(4))
        expect = (PULSE_PHASE + delay_time(DM, f_high, CF) / PERIOD) % 1.0
        for c in range(4):
            peak = raw[c, 0].argmax() / res.nbin
            err = min(abs(peak - expect), 1 - abs(peak - expect))
            assert err < 0.05, (c, peak, expect)


class TestFourthMoment:
    def test_moments_fold(self, pulsar_file):
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         npol_out=4, fourth_moment=True, block_parts=2)
        res = load_to_fold(pulsar_file, cfg)
        assert res.obs.npol == 14
        prof = res.normalized()[0, 0]  # [14, nbin]
        # plane 0 is Stokes I; plane 4 is <I^2>; by Cauchy-Schwarz the folded
        # <I^2> >= <I>^2 binwise (variance non-negative)
        ii = prof[0]
        i2 = prof[4]
        assert np.all(i2 >= ii**2 * 0.999)
        # the pulse appears in I
        assert abs(ii.argmax() / res.nbin - PULSE_PHASE) < 0.03


class TestDump:
    def test_dump_reingest(self, pulsar_file, tmp_path):
        """--dump writes a float32 DADA of the detected stream that the
        pipeline can re-ingest (FloatUnpacker path) and fold identically."""
        dump = str(tmp_path / "detected.dump")
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         block_parts=2, dump_path=dump)
        res1 = load_to_fold(pulsar_file, cfg)
        import os
        assert os.path.exists(dump)

        # re-ingest the dump: fold the already-detected float stream
        cfg2 = FoldConfig(folding_period=PERIOD, dispersion_measure=0.0,
                          coherent=False, nbin=res1.nbin,
                          min_block_samples=1 << 16)
        res2 = load_to_fold(dump, cfg2)
        p1 = res1.normalized()[0, 0, 0]
        p2 = res2.normalized()[0, 0, 0]
        # fixed-period folding references phase 0 to each file's own start
        # (as the reference's -c does), so the dump's nfilt_pos start shift
        # appears as a constant phase offset between the two runs
        from dspsr_jax.io.sources import open_source
        shift = (((open_source(dump).obs.start_time
                   - open_source(pulsar_file).obs.start_time) / PERIOD) % 1.0)
        expect = (p1.argmax() / res1.nbin - shift) % 1.0
        got = p2.argmax() / res2.nbin
        err = min(abs(got - expect), 1 - abs(got - expect))
        assert err < 0.02, (got, expect)


class TestSubintEpochs:
    def test_epochs_are_exact_division_starts(self, pulsar_file):
        """Each subint epoch equals the EXACT output time of its first
        folded sample: boundaries land mid-block at
        ``round(k * L * rate)`` output samples from the run start, NOT at
        the start of the next whole block (reference TimeDivide.C
        set_boundaries sample quantization + SubFold mid-block splits)."""
        sub = 0.011
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=sub,
                         min_block_samples=0)
        src = open_source(pulsar_file)
        pipe = FoldPipeline(src, cfg)
        res = pipe.run()
        assert len(res.epochs) >= 3

        rate_out = pipe.obs_out.rate
        t0 = pipe.output_start_time(0)
        # analytic boundaries: non-integer L references the run start
        for k, got in enumerate(res.epochs):
            bs = round(k * sub * rate_out) if k else 0
            exp = t0 + bs / rate_out
            assert abs(got - exp) < 1e-9, (k, float(got - exp))
        # interior integration lengths are sample-exact (whole divisions)
        for k in range(1, len(res.epochs) - 1):
            n = (round((k + 1) * sub * rate_out)
                 - round(k * sub * rate_out))
            assert abs(res.integration_length[k] - n / rate_out) < 1e-12
        # the first (partial head) + all others sum to the folded total
        nblocks_used = 0
        start = 0
        while start + pipe.block_in_samples <= src.total_samples:
            nblocks_used += 1
            start += pipe.stride_in_samples
        total_out = nblocks_used * pipe.out_per_block
        assert abs(res.integration_length.sum()
                   - total_out / rate_out) < 1e-9

    def test_epochs_with_seek(self, pulsar_file):
        """-S seek shifts all epochs by exactly the seek amount."""
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=0.011,
                         min_block_samples=0)
        r0 = FoldPipeline(open_source(pulsar_file), cfg).run()
        seek = 0.02
        import dataclasses as _dc

        cfg2 = _dc.replace(cfg, seek_seconds=seek)
        pipe2 = FoldPipeline(open_source(pulsar_file), cfg2)
        r2 = pipe2.run()
        seek_samples = int(seek * RATE)
        expect0 = pipe2.output_start_time(seek_samples)
        assert abs(r2.epochs[0] - expect0) < 1e-12

    def test_archive_offs_sub_gap_aware(self, pulsar_file, tmp_path):
        """OFFS_SUB in the written archive = epoch - obs start + tsub/2."""
        from dspsr_jax.io.psrfits import save_psrfits_fold
        from dspsr_jax.io.psrfits_in import load_psrfits_fold

        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=0.011,
                         min_block_samples=0)
        res = FoldPipeline(open_source(pulsar_file), cfg).run()
        p = str(tmp_path / "ep.ar")
        save_psrfits_fold(p, res)
        arch = load_psrfits_fold(p)
        offs = np.asarray(arch.offs_sub, float).reshape(-1)
        want = np.array([e - res.obs.start_time for e in res.epochs]) \
            + np.asarray(res.integration_length) / 2.0
        np.testing.assert_allclose(offs, want, atol=1e-9)


class TestSampleExactDivide:
    """Sample-exact TimeDivide/SubFold semantics end-to-end (reference
    Signal/Pulsar/TimeDivide.C:132-257 + SubFold.C:130-167): boundaries
    split BLOCKS at exact output samples via per-sample fold bounds."""

    def test_hits_count_division_samples_exactly(self, pulsar_file):
        """Per-subint hit totals equal the exact division sample counts —
        the boundary lands mid-block and the block folds once per
        division with complementary bounds."""
        sub = 0.011
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=sub,
                         min_block_samples=0)
        pipe = FoldPipeline(open_source(pulsar_file), cfg)
        res = pipe.run()
        rate_out = pipe.obs_out.rate
        nsub = len(res.epochs)
        assert nsub >= 3
        bs = [0] + [round(k * sub * rate_out) for k in range(1, nsub)]
        total = round(res.integration_length.sum() * rate_out)
        bs.append(total)
        for k in range(nsub):
            want = bs[k + 1] - bs[k]
            got = res.hits[k].sum(axis=-1)
            np.testing.assert_allclose(got, want, rtol=0, atol=0.5)
            assert abs(res.integration_length[k] * rate_out - want) < 0.5

    def test_engine_parity_at_boundary(self, pulsar_file):
        """Two block geometries (2 and 3 FFT windows per block) produce
        identical division bookkeeping and closely matching per-subint
        profiles with a mid-block -L."""
        sub = 0.013
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=sub,
                         min_block_samples=0, digitizer_stats=False)
        r_mega = FoldPipeline(open_source(pulsar_file), cfg).run()
        r_xla = FoldPipeline(open_source(pulsar_file),
                             dataclasses.replace(cfg, block_parts=3)).run()
        # the block sizes differ, so the amount of tail data consumed
        # (whole blocks only) differs: compare the common FULL subints;
        # the final partial one is geometry-dependent
        n = min(len(r_mega.epochs), len(r_xla.epochs)) - 1
        assert n >= 3
        np.testing.assert_allclose(r_mega.integration_length[:n],
                                   r_xla.integration_length[:n], atol=1e-9)
        for a, b in zip(r_mega.epochs[:n], r_xla.epochs[:n]):
            assert abs(a - b) < 1e-9
        # per-bin hit counts may differ by O(1) f32 bin-boundary jitter
        # (different phase-anchor segmenting); per-(subint, channel)
        # totals — the division sample counts — match EXACTLY
        np.testing.assert_allclose(r_mega.hits[:n].sum(axis=-1),
                                   r_xla.hits[:n].sum(axis=-1),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(r_mega.hits[:n], r_xla.hits[:n], atol=1.5)
        pa = r_mega.normalized()[:n]
        pb = r_xla.normalized()[:n]
        assert np.abs(pa - pb).max() / np.abs(pb).max() < 0.05

    def test_utc_aligned_integer_seconds(self, tmp_path):
        """Integer -L aligns divisions to UTC multiples of the length in
        the day (TimeDivide.C:70-81): a run starting at 02:05:45.3 with
        -L 1 has its first boundary at 02:05:46.000 exactly."""
        p = str(tmp_path / "frac_start.dada")
        synth_pulsar_dada(p, nsec=1.2)
        # rewrite header with a fractional-second UTC_START
        raw = open(p, "rb").read()
        hdr = raw[:4096].replace(b"2010-04-13-02:05:45",
                                 b"2010-04-13-02:05:45.300")
        with open(p, "wb") as f:
            f.write(hdr + raw[4096:])
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=1.0,
                         min_block_samples=0)
        pipe = FoldPipeline(open_source(p), cfg)
        res = pipe.run()
        assert len(res.epochs) == 2
        tsamp_out = 1.0 / pipe.obs_out.rate
        # epoch 0 = data start (partial first division)
        assert abs(res.epochs[0] - pipe.output_start_time(0)) < 1e-9
        # epoch 1 = the UTC second boundary, to one output sample
        assert abs(res.epochs[1].secs - 7546.0) <= tsamp_out
        # first division is ~0.7 s, NOT 1.0 s
        assert abs(res.integration_length[0] - (7546.0 - res.epochs[0].secs)) \
            <= tsamp_out

    def test_lepoch_overrides_reference(self, pulsar_file):
        """-Lepoch pins the division grid to an explicit MJD; data before
        the reference is discarded (the reference clamps divide_start to
        the division reference, TimeDivide.C:437-446 + set_bounds
        idat_start skip)."""
        pipe0 = FoldPipeline(open_source(pulsar_file),
                             FoldConfig(folding_period=PERIOD,
                                        dispersion_measure=DM, nchan=4,
                                        block_parts=2, min_block_samples=0))
        t0 = pipe0.output_start_time(0)
        rate_out = pipe0.obs_out.rate
        lep = t0 + 0.004  # 4 ms after the data starts
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_seconds=0.02,
                         min_block_samples=0,
                         integration_reference_epoch=lep.in_days())
        res = FoldPipeline(open_source(pulsar_file), cfg).run()
        tsamp_out = 1.0 / rate_out
        # the first subint starts AT Lepoch; the 4 ms head is discarded
        assert abs(res.epochs[0] - lep) <= tsamp_out
        assert abs(res.epochs[1] - (lep + 0.02)) <= tsamp_out
        assert abs(res.integration_length[0] - 0.02) <= tsamp_out
        # the discarded head is folded nowhere
        no_div = FoldPipeline(open_source(pulsar_file), FoldConfig(
            folding_period=PERIOD, dispersion_measure=DM, nchan=4,
            block_parts=2, min_block_samples=0)).run()
        missing = round((lep - t0) * rate_out)
        np.testing.assert_allclose(
            no_div.hits.sum(axis=(0, 2))[0] - res.hits.sum(axis=(0, 2))[0],
            missing, atol=1)

    def test_single_pulse_period_much_less_than_window(self, tmp_path):
        """-s single-pulse subints with the pulse period ≪ one FFT window
        (VERDICT r4 missing #1): every pulse becomes its own subint with
        phase-0 boundaries, many boundaries per block."""
        p = str(tmp_path / "sp.dada")
        synth_pulsar_dada(p, nsec=0.2)
        # window = nchan * freq_res = 4 * 32768 = 131072 input samples
        # = 32.8 ms; period 5 ms -> ~6.5 pulses per window
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, subint_turns=1,
                         frequency_resolution=32768, min_block_samples=0,
                         nbin=64)
        pipe = FoldPipeline(open_source(p), cfg)
        res = pipe.run()
        rate_out = pipe.obs_out.rate
        nsub = len(res.epochs)
        assert nsub >= 20  # ~0.19 s usable / 5 ms
        # interior subints hold exactly one period of samples
        for k in range(1, nsub - 1):
            assert abs(res.integration_length[k] - PERIOD) <= 1.5 / rate_out
        # every epoch sits at pulse phase 0 (to one sample of phase)
        for e in res.epochs:
            ph = pipe.predictor.fracturns(e)
            ph = min(ph, 1.0 - ph)
            assert ph <= 1.5 / (rate_out * PERIOD)
        # hits bookkeeping: folded samples = per-subint lengths exactly
        for k in range(nsub):
            want = round(res.integration_length[k] * rate_out)
            np.testing.assert_allclose(res.hits[k].sum(axis=-1), want,
                                       atol=0.5)

    def test_fractional_pulses_keeps_partial_head(self, tmp_path):
        """-y folds the partial first pulse; without it the data before
        the first phase-0 crossing is discarded (TimeDivide.C:122-129,
        425-429)."""
        p = str(tmp_path / "fy.dada")
        synth_pulsar_dada(p, nsec=0.1)
        base = dict(folding_period=PERIOD, dispersion_measure=DM,
                    nchan=4, block_parts=2, subint_turns=1,
                    frequency_resolution=32768, min_block_samples=0,
                    nbin=64)
        pipe_n = FoldPipeline(open_source(p), FoldConfig(**base))
        res_n = pipe_n.run()
        res_y = FoldPipeline(open_source(p), FoldConfig(
            fractional_pulses=True, **base)).run()
        rate_out = pipe_n.obs_out.rate
        t0 = pipe_n.output_start_time(0)
        # phase of the output start is mid-pulse (nfilt shift), so -y
        # gains a partial head subint starting AT the data start
        head = pipe_n.predictor.fracturns(t0)
        if head > 1e-3 and head < 1 - 1e-3:  # genuinely mid-pulse
            assert abs(res_y.epochs[0] - t0) < 1e-9
            assert res_n.epochs[0] - t0 > 0
            # without -y those head samples are folded NOWHERE
            n_total = res_n.hits.sum(axis=(0, 2))[0]
            y_total = res_y.hits.sum(axis=(0, 2))[0]
            missing = round((res_n.epochs[0] - t0) * rate_out)
            np.testing.assert_allclose(y_total - n_total, missing, atol=1)

    def test_blocks_per_step_boundary_in_first_batch(self, pulsar_file):
        """blocks_per_step=4 with a -L boundary inside batch 0: batching
        decisions come from exact boundaries, so the batched run divides
        identically to blocks_per_step=1."""
        sub = 0.009
        base = dict(folding_period=PERIOD, dispersion_measure=DM,
                    nchan=4, subint_seconds=sub, min_block_samples=0,
                    block_parts=1, digitizer_stats=False)
        r1 = FoldPipeline(open_source(pulsar_file),
                          FoldConfig(blocks_per_step=1, **base)).run()
        r4 = FoldPipeline(open_source(pulsar_file),
                          FoldConfig(blocks_per_step=4, **base)).run()
        assert len(r1.epochs) == len(r4.epochs)
        np.testing.assert_allclose(r1.integration_length,
                                   r4.integration_length, atol=1e-12)
        np.testing.assert_allclose(r1.hits, r4.hits, atol=0.5)
        np.testing.assert_allclose(r1.profiles, r4.profiles,
                                   rtol=1e-5, atol=1e-3)


class TestMultiPulsar:
    def test_two_pulsars_one_pass(self, tmp_path):
        """Fold two periods in one pass; each profile matches its
        single-pulsar run (LoadToFold1.C:1155-1242 multi-fold)."""
        p2 = PERIOD * 1.37
        path = synth_pulsar_dada(str(tmp_path / "mp.dada"), nsec=0.3)
        base = dict(dispersion_measure=DM, nchan=4, block_parts=2,
                    min_block_samples=0, nbin=32)
        cfg_multi = FoldConfig(folding_period=PERIOD,
                               additional_pulsars=(p2,), **base)
        res = load_to_fold(path, cfg_multi)
        assert res.extra_sources and len(res.extra_sources) == 1
        r2 = res.extra_sources[0]
        assert abs(r2.folding_period - p2) < 1e-12

        a = load_to_fold(path, FoldConfig(folding_period=PERIOD, **base))
        b = load_to_fold(path, FoldConfig(folding_period=p2, **base))
        np.testing.assert_allclose(res.profiles, a.profiles, rtol=1e-6)
        np.testing.assert_allclose(r2.profiles, b.profiles, rtol=1e-6)
        np.testing.assert_allclose(res.hits, a.hits, atol=1e-3)
        np.testing.assert_allclose(r2.hits, b.hits, atol=1e-3)
        # the real pulsar only shows up in its own fold
        snr_a = res.normalized()[0, :, 0, :].max() / res.normalized()[0, :, 0, :].mean()
        assert snr_a > 1.1


class TestDetectionStates:
    """Explicit detection states (VERDICT r2 item 7): COHERENCE folds the
    4-pol cross products (Detection.C:42-66) and converts to Stokes at
    archive time; PP/QQ fold single polarizations."""

    def test_coherence_fold_converts_to_stokes(self, tmp_path):
        from dspsr_jax.observation import Signal

        path = synth_pulsar_dada(str(tmp_path / "coh.dada"), nsec=0.1)
        base = dict(folding_period=PERIOD, dispersion_measure=DM, nchan=4,
                    block_parts=2, min_block_samples=0, nbin=32)
        rc = load_to_fold(path, FoldConfig(detection="coherence", **base))
        rs = load_to_fold(path, FoldConfig(npol_out=4, **base))
        assert rc.obs.state == Signal.COHERENCE
        assert rc.profiles.shape == rs.profiles.shape
        # detection is linear per product, folding is linear: the converted
        # coherence fold equals the Stokes fold numerically
        conv = rc.to_stokes()
        assert conv.obs.state == Signal.STOKES
        scale = np.abs(rs.profiles).max()
        assert np.abs(conv.profiles - rs.profiles).max() / scale < 2e-6
        np.testing.assert_allclose(conv.hits, rs.hits, atol=1e-3)

    def test_pp_qq_single_pol_folds(self, tmp_path):
        path = synth_pulsar_dada(str(tmp_path / "pq.dada"), nsec=0.06)
        base = dict(folding_period=PERIOD, dispersion_measure=DM, nchan=4,
                    block_parts=2, min_block_samples=0, nbin=32)
        r2 = load_to_fold(path, FoldConfig(npol_out=2, **base))
        rp = load_to_fold(path, FoldConfig(detection="pp", **base))
        rq = load_to_fold(path, FoldConfig(detection="qq", **base))
        assert rp.profiles.shape[2] == 1 and rq.profiles.shape[2] == 1
        scale = np.abs(r2.profiles).max()
        assert np.abs(rp.profiles[:, :, 0] - r2.profiles[:, :, 0]).max() \
            / scale < 2e-6
        assert np.abs(rq.profiles[:, :, 0] - r2.profiles[:, :, 1]).max() \
            / scale < 2e-6

    def test_coherence_archive_pol_type(self, tmp_path):
        from dspsr_jax.io.psrfits import save_psrfits_fold
        from dspsr_jax.io.fits import read_fits_headers

        path = synth_pulsar_dada(str(tmp_path / "ca.dada"), nsec=0.06)
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, min_block_samples=0,
                         nbin=32, detection="coherence")
        res = load_to_fold(path, cfg)
        ar = str(tmp_path / "coh.ar")
        save_psrfits_fold(ar, res)
        hdus = read_fits_headers(ar)
        sub = [h for h in hdus if "SUBINT" in str(h.get("EXTNAME", ""))][0]
        assert "AABBCRCI" in str(sub["POL_TYPE"])
        ar2 = str(tmp_path / "stk.ar")
        save_psrfits_fold(ar2, res.to_stokes())
        hdus2 = read_fits_headers(ar2)
        sub2 = [h for h in hdus2 if "SUBINT" in str(h.get("EXTNAME", ""))][0]
        assert "IQUV" in str(sub2["POL_TYPE"])


class TestPerSourceFoldGeometry:
    def test_auto_nbin_per_source(self, tmp_path):
        """With -b unset each pulsar gets its own choose_nbin from its own
        period (LoadToFold1.C:990-1092); every fold matches its
        single-pulsar run."""
        from dspsr_jax.io.sources import open_source
        from dspsr_jax.models.load_to_fold import FoldPipeline

        p2 = PERIOD / 7  # fast pulsar -> fewer phase bins than the primary
        path = synth_pulsar_dada(str(tmp_path / "nb.dada"), nsec=0.3)
        base = dict(dispersion_measure=DM, nchan=4, block_parts=2,
                    min_block_samples=0, nbin=0)
        pipe = FoldPipeline(open_source(path),
                            FoldConfig(folding_period=PERIOD,
                                       additional_pulsars=(p2,), **base))
        assert pipe.nbins[1] < pipe.nbins[0]  # shorter period, fewer bins
        res = pipe.run()
        r2 = res.extra_sources[0]
        assert res.profiles.shape[-1] == pipe.nbins[0]
        assert r2.profiles.shape[-1] == pipe.nbins[1]
        assert r2.nbin == pipe.nbins[1]

        a = load_to_fold(path, FoldConfig(folding_period=PERIOD, **base))
        b = load_to_fold(path, FoldConfig(folding_period=p2, **base))
        np.testing.assert_allclose(res.profiles, a.profiles, rtol=1e-6)
        np.testing.assert_allclose(r2.profiles, b.profiles, rtol=1e-6)

    def test_per_source_dm_from_par(self, tmp_path):
        """A .par additional source records ITS dm in its FoldResult."""
        from dspsr_jax.io.sources import open_source
        from dspsr_jax.models.load_to_fold import FoldPipeline

        par = tmp_path / "x.par"
        par.write_text("PSRJ  J0000+0000\nF0  3.7\nDM  12.5\n"
                       "PEPOCH 55000\nRAJ 00:00:00\nDECJ 00:00:00\n")
        path = synth_pulsar_dada(str(tmp_path / "pd.dada"), nsec=0.06)
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, min_block_samples=0,
                         nbin=32,
                         additional_pulsars=(str(par),))
        res = load_to_fold(path, cfg)
        assert res.dispersion_measure == DM
        assert res.extra_sources[0].dispersion_measure == 12.5


class TestCalFolding:
    def test_cal_mode_recovers_square_wave(self, tmp_path):
        """MODE=CAL + CALFREQ: fold at the cal square-wave frequency with no
        ephemeris (Fold.C:190-227 CAL branch)."""
        from dspsr_jax.io.dada import format_ascii_header, header_from_observation
        from dspsr_jax.timing.mjd import MJD
        from dspsr_jax.observation import Observation, Signal

        rng = np.random.default_rng(8)
        rate = 1e6
        calfreq = 11.123  # Hz
        nsamp = 1 << 18
        t = np.arange(nsamp) / rate
        on = ((t * calfreq) % 1.0) < 0.5
        amp = np.where(on, 3.0, 1.0)
        x = rng.standard_normal((nsamp, 2, 2)) * amp[:, None, None] * 8
        q = np.clip(np.round(x + 127.5), 0, 255).astype(np.uint8)
        obs = Observation(nchan=1, npol=2, ndim=2, nbit=8,
                          centre_frequency=1400.0, bandwidth=-1.0, rate=rate,
                          start_time=MJD(55000, 0.3), state=Signal.ANALYTIC,
                          source="CAL_SRC", telescope="PKS", instrument="T",
                          mode="CAL", calfreq=calfreq)
        path = str(tmp_path / "cal.dada")
        with open(path, "wb") as f:
            f.write(format_ascii_header(header_from_observation(obs)))
            f.write(q.tobytes())

        cfg = FoldConfig(nchan=4, nbin=32, block_parts=2,
                         min_block_samples=0, dispersion_measure=0.0,
                         coherent=False)
        res = load_to_fold(path, cfg)
        assert abs(res.folding_period - 1.0 / calfreq) < 1e-12
        prof = res.normalized()[0].sum(axis=0)[0]  # [nbin]
        nbin = prof.shape[0]
        hi = np.sort(prof)[-nbin // 3:].mean()
        lo = np.sort(prof)[: nbin // 3].mean()
        # square wave: on-power / off-power ~ 9
        assert hi / lo > 4, (hi, lo)
        # ~half the bins are high
        mid = 0.5 * (hi + lo)
        frac_on = (prof > mid).mean()
        assert 0.3 < frac_on < 0.7


class TestApodizationAndPassband:
    def test_fft_window_applied_and_pulse_recovered(self, pulsar_file):
        base = dict(folding_period=PERIOD, dispersion_measure=DM, nchan=4,
                    block_parts=2, min_block_samples=0, nbin=32)
        plain = load_to_fold(pulsar_file, FoldConfig(**base))
        win = load_to_fold(pulsar_file, FoldConfig(fft_window="hanning",
                                                   **base))
        # window changes the numbers but not the detection of the pulse
        assert not np.allclose(plain.profiles, win.profiles)
        for res in (plain, win):
            prof = res.normalized()[0, :, 0, :]
            snr = (prof.max(axis=1) - prof.mean(axis=1)) / prof.std(axis=1)
            assert (snr > 1.5).all()

    def test_passband_integrates(self, pulsar_file):
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         nchan=4, block_parts=2, min_block_samples=0,
                         nbin=32, passband=True)
        res = load_to_fold(pulsar_file, cfg)
        assert res.passband is not None
        nchan, npol, nres = res.passband.shape
        assert nchan == 4 and npol == 2
        assert (res.passband > 0).all()
        # white-ish noise: per-channel band power within a factor of a few
        per_chan = res.passband.sum(axis=(1, 2))
        assert per_chan.max() / per_chan.min() < 5

    def test_archive_extensions_polyco_param_bandpass(self, tmp_path):
        """Archive carries POLYCO, PSRPARAM and BANDPASS extensions
        (Archiver.C / ArchiverExtensions.C roles)."""
        from dspsr_jax.io.psrfits import save_psrfits_fold
        from dspsr_jax.io.fits import read_fits_headers
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD
        from dspsr_jax.io.sources import RawFileSource

        rng = np.random.default_rng(2)
        obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                          centre_frequency=1400.0, bandwidth=-2.0, rate=1e6,
                          start_time=MJD.from_utc("2010-04-13-02:05:45"),
                          state=Signal.NYQUIST, source="J0835-4510",
                          telescope="PKS", instrument="RAW")
        p = str(tmp_path / "vela.raw")
        with open(p, "wb") as f:
            f.write(rng.integers(0, 256, 1 << 17).astype(np.uint8).tobytes())
        cfg = FoldConfig(polyco_path="/root/reference/Benchmark/vela.polyco",
                         ephemeris_path="/root/reference/Benchmark/vela.par",
                         dispersion_measure=67.99, nchan=4, nbin=32,
                         block_parts=2, min_block_samples=0, passband=True)
        res = FoldPipeline(RawFileSource(p, obs), cfg).run()
        ar = str(tmp_path / "vela.ar")
        save_psrfits_fold(ar, res)
        hdus = read_fits_headers(ar)
        names = [h.get("EXTNAME", "").strip("' ") for h in hdus]
        for want in ("POLYCO", "PSRPARAM", "BANDPASS", "SUBINT", "HISTORY"):
            assert want in names, (want, names)
        pc = hdus[names.index("POLYCO")]
        assert int(pc["NAXIS2"]) >= 1
