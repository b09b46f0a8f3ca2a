"""PSRFITS writer tests: FITS structure validity + data round trips."""

import numpy as np
import pytest

from dspsr_jax.io.fits import (
    FitsWriter, read_fits_headers, read_bintable_column,
)
from dspsr_jax.io.psrfits import save_psrfits_fold, PsrfitsSearchWriter
from dspsr_jax.io.archive import save_archive
from dspsr_jax.models.load_to_fold import FoldConfig, load_to_fold
from dspsr_jax.models.load_to_fil import FilConfig, load_to_fits
from test_pipeline import synth_pulsar_dada, PERIOD, DM, PULSE_PHASE


class TestFitsWriter:
    def test_structure(self, tmp_path):
        p = str(tmp_path / "t.fits")
        with open(p, "wb") as f:
            w = FitsWriter(f)
            w.write_primary([("OBSFREQ", 1400.0, "MHz")])
            w.write_bintable(
                "TEST",
                [("A", "1D", "s", np.arange(3.0)),
                 ("B", "4E", "", np.arange(12.0).reshape(3, 4).astype(np.float32))],
            )
        import os
        assert os.path.getsize(p) % 2880 == 0
        hdus = read_fits_headers(p)
        assert hdus[0]["SIMPLE"] == "T"
        assert hdus[1]["EXTNAME"] == "TEST"
        assert int(hdus[1]["NAXIS1"]) == 8 + 16
        a = read_bintable_column(p, "TEST", "A")
        np.testing.assert_allclose(a.ravel(), [0, 1, 2])
        b = read_bintable_column(p, "TEST", "B")
        np.testing.assert_allclose(b, np.arange(12).reshape(3, 4))


@pytest.fixture(scope="module")
def fold_result(tmp_path_factory):
    p = tmp_path_factory.mktemp("pf") / "psr.dada"
    synth_pulsar_dada(str(p), nsec=0.2)
    cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                     nchan=4, npol_out=2, subint_seconds=0.08, block_parts=2)
    return load_to_fold(str(p), cfg)


class TestPsrfitsFold:
    def test_write_and_structure(self, fold_result, tmp_path):
        p = str(tmp_path / "fold.sf")
        save_psrfits_fold(p, fold_result)
        hdus = read_fits_headers(p)
        assert hdus[0]["FITSTYPE"] == "PSRFITS"
        assert hdus[0]["OBS_MODE"] == "PSR"
        sub = next(h for h in hdus if h.get("EXTNAME") == "SUBINT")
        assert int(sub["NBIN"]) == fold_result.nbin
        assert int(sub["NCHAN"]) == 4
        assert int(sub["NPOL"]) == 2
        assert int(sub["NAXIS2"]) == fold_result.profiles.shape[0]

    def test_data_roundtrip(self, fold_result, tmp_path):
        p = str(tmp_path / "fold2.sf")
        save_psrfits_fold(p, fold_result)
        nsub = fold_result.profiles.shape[0]
        nchan, npol, nbin = 4, 2, fold_result.nbin
        data = read_bintable_column(p, "SUBINT", "DATA").astype(np.float64)
        scl = read_bintable_column(p, "SUBINT", "DAT_SCL").astype(np.float64)
        offs = read_bintable_column(p, "SUBINT", "DAT_OFFS").astype(np.float64)
        # DATA order (npol, nchan, nbin); SCL/OFFS order (nchan, npol)
        data = data.reshape(nsub, npol, nchan, nbin)
        scl = scl.reshape(nsub, nchan, npol).transpose(0, 2, 1)
        offs = offs.reshape(nsub, nchan, npol).transpose(0, 2, 1)
        recon = data * scl[..., None] + offs[..., None]
        expect = fold_result.normalized().transpose(0, 2, 1, 3)
        span = expect.max() - expect.min()
        np.testing.assert_allclose(recon, expect, atol=1e-4 * span + 1e-5)

    def test_save_archive_routes_by_extension(self, fold_result, tmp_path):
        p = str(tmp_path / "route.sf")
        save_archive(p, fold_result)
        assert read_fits_headers(p)[0]["FITSTYPE"] == "PSRFITS"
        p2 = str(tmp_path / "route.npz")
        save_archive(p2, fold_result)
        from dspsr_jax.io.archive import load_archive
        assert load_archive(p2)["meta"]["nbin"] == fold_result.nbin


class TestPsrfitsSearch:
    def test_digifits_end_to_end(self, tmp_path):
        src = str(tmp_path / "s.dada")
        synth_pulsar_dada(src, nsec=0.1)
        out = str(tmp_path / "search.sf")
        cfg = FilConfig(nchan=16, tscrunch_factor=4, nbits=8, block_parts=2)
        obs = load_to_fits(src, out, cfg)
        hdus = read_fits_headers(out)
        assert hdus[0]["OBS_MODE"] == "SEARCH"
        sub = next(h for h in hdus if h.get("EXTNAME") == "SUBINT")
        assert int(sub["NCHAN"]) == 16
        assert int(sub["NBITS"]) == 8
        assert int(sub["NSBLK"]) == 4096
        assert int(sub["NAXIS2"]) >= 1
        data = read_bintable_column(out, "SUBINT", "DATA")
        # data should have sensible 8-bit stats (mean near digi_mean 127.5)
        assert 100 < data[:-1].astype(float).mean() < 155


class TestPsrfitsInput:
    def test_read_back_search_file(self, tmp_path):
        """Write a search-mode PSRFITS, read it back as a Source."""
        from dspsr_jax.io.sources import open_source
        from dspsr_jax.io.psrfits_in import PsrfitsSearchFile

        src_dada = str(tmp_path / "in.dada")
        synth_pulsar_dada(src_dada, nsec=0.05)
        out = str(tmp_path / "rb.sf")
        cfg = FilConfig(nchan=8, tscrunch_factor=8, nbits=8, block_parts=2)
        load_to_fits(src_dada, out, cfg)

        s = open_source(out)
        assert isinstance(s, PsrfitsSearchFile)
        assert s.obs.nchan == 8
        assert s.obs.nbit == 8
        assert s.total_samples > 0
        a = s.read_samples(0, 100)
        assert a.shape == (100 * 8,)
        # spot check against the DATA column read row-wise
        col = read_bintable_column(out, "SUBINT", "DATA")
        np.testing.assert_array_equal(a, col.ravel()[: 100 * 8])
        # crossing into the middle of the (single) row
        mid = s.nsblk // 2
        b = s.read_samples(mid - 10, 20)
        np.testing.assert_array_equal(
            b, col.ravel()[(mid - 10) * 8 : (mid + 10) * 8])


class TestRawHeaderSource:
    def test_fold_headerless_raw(self, tmp_path):
        from dspsr_jax.io.sources import RawFileSource, observation_from_keyvals
        from test_pipeline import RATE, CF, BW

        p = str(tmp_path / "raw.dat")
        synth_pulsar_dada(str(tmp_path / "tmp.dada"), nsec=0.05)
        # strip the header to make a raw file
        with open(str(tmp_path / "tmp.dada"), "rb") as f:
            f.seek(4096)
            payload = f.read()
        with open(p, "wb") as f:
            f.write(payload)
        obs = observation_from_keyvals([
            f"FREQ={CF}", f"BW={BW}", "NCHAN=1", "NPOL=2", "NDIM=2",
            "NBIT=8", f"TSAMP={1e6 / RATE}",
            "UTC_START=2010-04-13-02:05:45", "SOURCE=RAW"])
        src = RawFileSource(p, obs)
        assert src.total_samples == len(payload) // 4
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
        res = FoldPipeline(src, FoldConfig(
            folding_period=PERIOD, dispersion_measure=DM, block_parts=2)).run()
        assert res.hits.sum() > 0


class TestSubintTurns:
    def test_turn_divisions(self, tmp_path):
        from dspsr_jax.models.load_to_fold import FoldConfig, load_to_fold
        p = str(tmp_path / "turns.dada")
        synth_pulsar_dada(p, nsec=0.3)
        # 10 turns of 5 ms = 50 ms per subint over 0.3 s -> ~6 subints
        cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                         subint_turns=10, block_parts=2,
                         min_block_samples=1 << 16)
        res = load_to_fold(p, cfg)
        assert 4 <= res.profiles.shape[0] <= 7, res.profiles.shape


class TestPsrfitsFoldRead:
    def test_load_fold_archive_roundtrip(self, fold_result, tmp_path):
        from dspsr_jax.io.psrfits_in import load_psrfits_fold
        p = str(tmp_path / "rt.sf")
        save_psrfits_fold(p, fold_result)
        arch = load_psrfits_fold(p)
        assert arch.nsub == fold_result.profiles.shape[0]
        assert arch.nchan == 4 and arch.npol == 2
        assert arch.nbin == fold_result.nbin
        expect = fold_result.normalized()
        span = expect.max() - expect.min()
        np.testing.assert_allclose(arch.profiles, expect,
                                   atol=1e-4 * span + 1e-5)
        assert abs(arch.period - fold_result.folding_period) < 1e-12
        assert arch.source == (fold_result.obs.source or "unknown")
        np.testing.assert_allclose(
            arch.freqs,
            [fold_result.obs.centre_frequency_of(i) for i in range(4)])

    def test_load_fold_rejects_search(self, tmp_path):
        from dspsr_jax.io.psrfits_in import load_psrfits_fold
        from dspsr_jax.io.psrfits import PsrfitsSearchWriter
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD
        obs = Observation(nchan=4, npol=1, ndim=1, nbit=8,
                          centre_frequency=1400.0, bandwidth=-4.0,
                          rate=1000.0, start_time=MJD.from_mjd(55000.0),
                          state=Signal.INTENSITY, source="X")
        p = str(tmp_path / "srch.sf")
        with PsrfitsSearchWriter(p, obs, nbits=8) as w:
            w.write_block(np.zeros((16, 4), np.uint8))
        with pytest.raises(ValueError):
            load_psrfits_fold(p)
