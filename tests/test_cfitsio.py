"""External validation: files we write, read back through the SYSTEM
cfitsio library (the same third-party code the reference links against) —
breaking the self-referential round-trip loop flagged in round 1."""

import numpy as np
import pytest

from dspsr_jax.io.cfitsio import available, CfitsioFile, verify_psrfits_fold

pytestmark = pytest.mark.skipif(not available(),
                                reason="libcfitsio not present")


@pytest.fixture(scope="module")
def fold_result(tmp_path_factory):
    from dspsr_jax.observation import Observation, Signal
    from dspsr_jax.timing.mjd import MJD
    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    tmp = tmp_path_factory.mktemp("cf")
    rng = np.random.default_rng(1)
    p = str(tmp / "x.raw")
    with open(p, "wb") as f:
        f.write(rng.integers(0, 256, 1 << 17).astype(np.uint8).tobytes())
    obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                      centre_frequency=1400.0, bandwidth=-2.0, rate=1e6,
                      start_time=MJD.from_utc("2010-04-13-02:05:45"),
                      state=Signal.NYQUIST, source="J0835-4510",
                      telescope="PKS", instrument="RAW")
    cfg = FoldConfig(polyco_path="/root/reference/Benchmark/vela.polyco",
                     dispersion_measure=67.99, nchan=4, nbin=32,
                     block_parts=2, min_block_samples=0, passband=True,
                     subint_seconds=0.02,
                     ephemeris_path="/root/reference/Benchmark/vela.par")
    return FoldPipeline(RawFileSource(p, obs), cfg).run(), tmp


class TestFoldArchiveThroughCfitsio:
    def test_structure_and_values(self, fold_result):
        from dspsr_jax.io.psrfits import save_psrfits_fold

        res, tmp = fold_result
        path = str(tmp / "v.ar")
        save_psrfits_fold(path, res)
        metrics = verify_psrfits_fold(path, res)
        assert metrics["nsub"] == res.profiles.shape[0]
        assert metrics["max_profile_err"] < 1e-3

    def test_extensions_visible_to_cfitsio(self, fold_result):
        from dspsr_jax.io.psrfits import save_psrfits_fold

        res, tmp = fold_result
        path = str(tmp / "v2.ar")
        save_psrfits_fold(path, res)
        with CfitsioFile(path) as f:
            names = f.hdu_names()
            for want in ("HISTORY", "DIG_CNTS", "BANDPASS", "PSRPARAM",
                         "POLYCO", "SUBINT"):
                assert want in names, (want, names)
            f.move_to("POLYCO")
            f0 = f.read_col("REF_F0", 1)[0, 0]
            assert abs(f0 - 11.19) < 0.1  # Vela spin frequency
            nspan = f.read_col("NSPAN", 1, np.int16)[0, 0]
            assert nspan > 0
            f.move_to("SUBINT")
            assert f.key_float("DM") == pytest.approx(67.99)

    def test_bandpass_value_roundtrip(self, fold_result):
        """A reader applying the PSRFITS convention v = offs + scl*data must
        reconstruct the integrated bandpass (ADVICE r2: DAT_OFFS was 0,
        shifting every value by -32768*scale/65535)."""
        from dspsr_jax.io.psrfits import save_psrfits_fold

        res, tmp = fold_result
        path = str(tmp / "vbp.ar")
        save_psrfits_fold(path, res)
        pb = np.asarray(res.passband, np.float64)  # [nchan, npol, nres]
        nchan, npol, nres = pb.shape
        with CfitsioFile(path) as f:
            f.move_to("BANDPASS")
            offs = f.read_col("DAT_OFFS", npol)[0]
            scl = f.read_col("DAT_SCL", npol)[0]
            data = f.read_col("DATA", npol * nchan * nres, np.int16)[0]
        v = (offs[:, None] + scl[:, None]
             * data.astype(np.float64).reshape(npol, nchan * nres))
        want = pb.transpose(1, 0, 2).reshape(npol, nchan * nres)
        step = scl.max()  # one quantization step
        assert np.abs(v - want).max() <= step

    def test_primary_keywords(self, fold_result):
        from dspsr_jax.io.psrfits import save_psrfits_fold

        res, tmp = fold_result
        path = str(tmp / "v3.ar")
        save_psrfits_fold(path, res)
        with CfitsioFile(path) as f:
            f.move_abs(1)
            assert f.key_str("OBS_MODE") == "PSR"
            assert f.key_str("SRC_NAME") == "J0835-4510"
            assert f.key_int("STT_IMJD") == 55299


class TestSearchFileThroughCfitsio:
    def test_search_mode_streamed_rows(self, tmp_path):
        from dspsr_jax.io.psrfits import PsrfitsSearchWriter
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD

        obs = Observation(nchan=8, npol=1, ndim=1, nbit=8,
                          centre_frequency=1400.0, bandwidth=-2.0, rate=1e4,
                          start_time=MJD(55000, 0.1),
                          state=Signal.INTENSITY, source="S",
                          telescope="PKS", instrument="T")
        path = str(tmp_path / "s.sf")
        rng = np.random.default_rng(0)
        blocks = [rng.integers(0, 256, 8 * 1024).astype(np.uint8)
                  for _ in range(5)]
        with PsrfitsSearchWriter(path, obs, nbits=8, nsblk=1024) as w:
            for b in blocks:
                w.write_block(b)
        with CfitsioFile(path) as f:
            f.move_to("SUBINT")
            assert f.num_rows() == 5
            assert f.key_int("NSBLK") == 1024
            data = f.read_col("DATA", 8 * 1024, np.int16)
            want = np.stack(blocks)
            np.testing.assert_array_equal(data.astype(np.uint8), want)
            offs = f.read_col("OFFS_SUB", 1)[:, 0]
            tsub = 1024 / 1e4
            np.testing.assert_allclose(
                offs, (np.arange(5) + 0.5) * tsub, rtol=1e-12)
