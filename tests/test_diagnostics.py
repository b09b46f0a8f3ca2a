"""Diagnostic app tests (dmsmear/digimon/load_bits/cbird equivalents)."""

import numpy as np
import pytest

from dspsr_jax.apps import diagnostics


def _mkdada(path, payload: bytes, nbit=8, npol=1, ndim=1, nchan=1):
    hdr = (f"HDR_VERSION 1.0\nHDR_SIZE 4096\nBW 4.0\nFREQ 1400.0\n"
           f"NCHAN {nchan}\nNPOL {npol}\nNDIM {ndim}\nNBIT {nbit}\n"
           "TSAMP 0.125\nUTC_START 2010-04-13-02:05:45\nOBS_OFFSET 0\n"
           "SOURCE DIAG\nTELESCOPE PKS\nINSTRUMENT TEST\n").encode()
    with open(path, "wb") as f:
        f.write(hdr + b"\0" * (4096 - len(hdr)))
        f.write(payload)


class TestDigimon:
    def test_gain_command(self, tmp_path, capsys, rng):
        # 8-bit stream digitized 3x too quiet: unpacked variance << 1 ->
        # GAIN ~3; the trim (LEVEL) is held while far from good, matching
        # LevelMonitor.C:391 "don't bother adjusting the trim..."
        from dspsr_jax.unpack.bittable import optimal_spacing
        d = optimal_spacing(8)
        sigma_codes = 1.0 / d / 3.0  # 3x too quiet
        x = rng.normal(8.0, sigma_codes, size=1 << 16)
        codes = np.clip(np.round(x) + 128, 0, 255).astype(np.uint8)
        p = str(tmp_path / "quiet.dada")
        _mkdada(p, codes.tobytes())
        diagnostics.digimon([p, "-n", "32768", "-i", "2"])
        out = capsys.readouterr().out.strip().splitlines()
        gains = [float(l.split()[4]) for l in out if l.startswith("GAIN")]
        assert gains and 2.0 < gains[0] < 4.5, out
        assert not any(l.startswith("LEVEL") for l in out), out

    def test_level_command(self, tmp_path, capsys, rng):
        # correct gain, +5 code offset -> LEVEL line with the unpacked mean
        from dspsr_jax.unpack.bittable import optimal_spacing
        d = optimal_spacing(8)
        x = rng.normal(5.0, 1.0 / d, size=1 << 16)
        codes = np.clip(np.round(x) + 128, 0, 255).astype(np.uint8)
        p = str(tmp_path / "offs.dada")
        _mkdada(p, codes.tobytes())
        diagnostics.digimon([p, "-n", "32768", "-i", "2"])
        out = capsys.readouterr().out.strip().splitlines()
        levels = [float(l.split()[4]) for l in out if l.startswith("LEVEL")]
        assert levels and 0.1 < levels[0] < 0.3, out  # 5 codes * d ~ 0.167

    def test_well_set_levels_quiet(self, tmp_path, capsys, rng):
        from dspsr_jax.unpack.bittable import optimal_spacing
        d = optimal_spacing(8)
        x = rng.normal(0.0, 1.0 / d, size=1 << 16)
        codes = np.clip(np.round(x) + 128, 0, 255).astype(np.uint8)
        p = str(tmp_path / "good.dada")
        _mkdada(p, codes.tobytes())
        diagnostics.digimon([p, "-n", "32768", "-i", "2",
                             "--var-tolerance", "0.05",
                             "--mean-tolerance", "0.05"])
        out = capsys.readouterr().out
        assert "GAIN" not in out and "LEVEL" not in out, out


class TestLoadBits:
    def test_bit_dump(self, tmp_path, capsys):
        payload = bytes([0b10110001, 0b00000000, 0b11111111])
        p = str(tmp_path / "bits.dada")
        _mkdada(p, payload + b"\0" * 61)  # pad to whole samples
        diagnostics.load_bits([p, "-n", "3"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0] == "10110001"
        assert lines[1] == "00000000"
        assert lines[2] == "11111111"


class TestCbird:
    def test_flags_spike(self, tmp_path, capsys):
        nchan = 256
        rng = np.random.default_rng(7)
        freq = np.linspace(1300.0, 1400.0, nchan)
        power = (1.0 + 0.1 * np.sin(np.arange(nchan) / 17.0)
                 + rng.normal(0, 0.02, nchan))
        power[100] = 8.0  # birdie
        power[200] = 6.0
        rows = np.column_stack([freq, power])
        p = str(tmp_path / "band.txt")
        np.savetxt(p, rows)
        diagnostics.cbird([p, "-t", "4.0", "-w", "0.05"])
        out = capsys.readouterr().out.strip().splitlines()
        chans = [int(l.split()[0]) for l in out]
        assert 100 in chans and 200 in chans
        assert len(chans) <= 6  # no mass false positives


class TestDspsrCliOptions:
    def test_set_name_archive_options(self, tmp_path):
        """--set / -N / -a / -e reach the pipeline (reference --set via
        TextInterface + ObservationChange; -a archive class)."""
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main
        from dspsr_jax.io.fits import read_fits_headers

        rng = np.random.default_rng(0)
        raw = str(tmp_path / "cli.raw")
        with open(raw, "wb") as f:
            f.write(rng.integers(0, 256, 1 << 16).astype(np.uint8).tobytes())
        out = str(tmp_path / "cli.ar")
        rc = main([raw, "--header", "FREQ=1400", "BW=-2", "NCHAN=1",
                   "NPOL=2", "NDIM=1", "NBIT=8", "TSAMP=1.0",
                   "UTC_START=2010-04-13-02:05:45",
                   "-c", "0.005", "-D", "3", "-F", "4", "-b", "32",
                   "-N", "J0000+0000", "--set", "telescope=GBT",
                   "-a", "psrfits", "-O", out, "-q",
                   "--fft-window", "hanning", "--pulsar", "0.007"])
        assert rc == 0
        hdus = read_fits_headers(out)
        prim = hdus[0]
        assert "J0000+0000" in prim.get("SRC_NAME", "")
        assert "GBT" in prim.get("TELESCOP", "")
        import os
        assert os.path.exists(out.replace(".ar", "_src1.ar"))

    def test_set_coerces_bool_and_declared_types(self):
        """--set KEY=VAL coerces by the DECLARED field type: 'False' must
        yield False for bools, and None-valued numeric fields must become
        numbers (ADVICE r2: type(cur)('False') was True; None stayed str)."""
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD
        from dspsr_jax.apps.dspsr_app import coerce_set_value

        o = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                        centre_frequency=1400.0, bandwidth=-2.0, rate=1e6,
                        start_time=MJD(55000, 0.1), state=Signal.NYQUIST,
                        source="X", telescope="PKS", instrument="T")
        assert coerce_set_value(o, "dc_centred", "False") is False
        assert coerce_set_value(o, "dc_centred", "true") is True
        # calfreq is declared float but defaults to 0.0/None-ish; numeric
        assert coerce_set_value(o, "calfreq", "11.125") == 11.125
        assert isinstance(coerce_set_value(o, "calfreq", "11.125"), float)
        assert coerce_set_value(o, "nchan", "16") == 16
        # enum-valued fields still coerce through the value's type
        assert coerce_set_value(o, "state", "Analytic") is Signal.ANALYTIC
        import pytest as _pt
        with _pt.raises(AttributeError):
            coerce_set_value(o, "no_such_field", "1")


class TestThreadedClis:
    def test_dspsr_threads_option(self, tmp_path):
        """dspsr -t N runs the sharded pipeline end-to-end."""
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        rng = np.random.default_rng(1)
        raw = str(tmp_path / "t.raw")
        with open(raw, "wb") as f:
            f.write(rng.integers(0, 256, 1 << 18).astype(np.uint8).tobytes())
        out = str(tmp_path / "t.npz")
        rc = main([raw, "--header", "FREQ=1400", "BW=-2", "NCHAN=1",
                   "NPOL=2", "NDIM=1", "NBIT=8", "TSAMP=1.0",
                   "UTC_START=2010-04-13-02:05:45",
                   "-c", "0.005", "-D", "3", "-F", "4", "-b", "32",
                   "-t", "4", "--chan-shards", "2", "-O", out, "-q"])
        assert rc == 0
        d = np.load(out, allow_pickle=True)
        assert d["profiles"].shape[-1] == 32

    def test_digifil_threads_option(self, tmp_path):
        import numpy as np
        from dspsr_jax.apps.digifil_app import main
        from dspsr_jax.io.dada import format_ascii_header, header_from_observation
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD

        rng = np.random.default_rng(1)
        obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                          centre_frequency=1400.0, bandwidth=-2.0, rate=1e6,
                          start_time=MJD(55000, 0.2), state=Signal.NYQUIST,
                          source="X", telescope="PKS", instrument="T")
        p = str(tmp_path / "t.dada")
        with open(p, "wb") as f:
            f.write(format_ascii_header(header_from_observation(obs)))
            f.write(rng.integers(0, 256, 1 << 19).astype(np.uint8).tobytes())
        out = str(tmp_path / "t.fil")
        rc = main([p, "-o", out, "-F", "4", "-D", "2", "-b", "8",
                   "--threads", "4", "-c", "-q"])
        assert rc == 0
        import os
        assert os.path.getsize(out) > 1000
        # -T/--total must limit the sharded run too (ADVICE r2: it was
        # silently ignored with --threads > 1)
        out_t = str(tmp_path / "t_cut.fil")
        rc = main([p, "-o", out_t, "-F", "4", "-D", "2", "-b", "8",
                   "--threads", "4", "-c", "-q", "-T", "0.08"])
        assert rc == 0
        assert 0 < os.path.getsize(out_t) < os.path.getsize(out)


class TestCliTailOptions:
    def test_minimum_integration_drops_short_subint(self, tmp_path):
        """-m discards the trailing partial subint (reference
        PhaseSeriesUnloader::set_minimum_integration_length)."""
        import numpy as np
        from dspsr_jax.observation import Observation, Signal
        from dspsr_jax.timing.mjd import MJD
        from dspsr_jax.io.sources import RawFileSource
        from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

        rng = np.random.default_rng(3)
        obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                          centre_frequency=1400.0, bandwidth=-2.0, rate=1e6,
                          start_time=MJD(55000, 0.2), state=Signal.NYQUIST,
                          source="X", telescope="PKS", instrument="RAW")
        p = str(tmp_path / "mi.raw")
        with open(p, "wb") as f:
            f.write(rng.integers(0, 256, 1 << 18).astype(np.uint8).tobytes())
        base = dict(folding_period=0.004, dispersion_measure=3.0, nchan=4,
                    nbin=32, block_parts=2, min_block_samples=0,
                    subint_seconds=0.05)
        full = FoldPipeline(RawFileSource(p, obs), FoldConfig(**base)).run()
        cut = FoldPipeline(RawFileSource(p, obs),
                           FoldConfig(minimum_integration_length=0.045,
                                      **base)).run()
        assert full.profiles.shape[0] > cut.profiles.shape[0]
        assert (cut.integration_length >= 0.045).all()

    def test_post_script_hook_runs(self, tmp_path):
        """-J runs the post-processing script on each written archive
        (reference psrsh hook)."""
        import os
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        rng = np.random.default_rng(0)
        raw = str(tmp_path / "pj.raw")
        with open(raw, "wb") as f:
            f.write(rng.integers(0, 256, 1 << 16).astype(np.uint8).tobytes())
        marker = tmp_path / "seen.txt"
        script = tmp_path / "hook.sh"
        script.write_text(f"#!/bin/sh\necho \"$1\" >> {marker}\n")
        script.chmod(0o755)
        out = str(tmp_path / "pj.ar")
        rc = main([raw, "--header", "FREQ=1400", "BW=-2", "NCHAN=1",
                   "NPOL=2", "NDIM=1", "NBIT=8", "TSAMP=1.0",
                   "UTC_START=2010-04-13-02:05:45",
                   "-c", "0.005", "-D", "3", "-F", "4", "-b", "32",
                   "-a", "psrfits", "-O", out, "-q",
                   "-J", str(script)])
        assert rc == 0
        assert marker.exists() and out in marker.read_text()


class TestDspsrCliTail:
    """Round-4 CLI tail: -B/-f/-k/--mjd/-C source overrides, -2 excision
    code, --cepoch, -s single pulse, --nsub archive splitting, -w
    predictors file, --skz_start/end (reference dspsr.C:225-500)."""

    def _raw(self, tmp_path, n=1 << 16):
        import numpy as np

        rng = np.random.default_rng(0)
        p = str(tmp_path / "tail.raw")
        with open(p, "wb") as f:
            f.write(rng.integers(0, 256, n).astype(np.uint8).tobytes())
        return p

    HDR = ["--header", "FREQ=1400", "BW=-2", "NCHAN=1", "NPOL=2", "NDIM=1",
           "NBIT=8", "TSAMP=1.0", "UTC_START=2010-04-13-02:05:45"]

    def test_source_overrides(self, tmp_path):
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        raw = self._raw(tmp_path)
        out = str(tmp_path / "o.npz")
        rc = main([raw, *self.HDR, "-c", "0.005", "-F", "4", "-D", "3",
                   "-b", "16", "-O", out, "-q",
                   "--bandwidth=-4.0", "-f", "1500.0", "-k", "GBT",
                   "--mjd", "55299.5", "-C", "1.5"])
        assert rc == 0
        from dspsr_jax.io.archive import load_archive

        z = load_archive(out)
        assert float(z["meta"]["centre_frequency"]) == 1500.0
        assert float(z["meta"]["bandwidth"]) == -4.0
        assert z["meta"]["telescope"] == "GBT"
        # epoch = --mjd + clock offset + pipeline start shift; just check
        # the day is the overridden one
        assert abs(float(z["epochs_mjd"][0]) - 55299.5) < 0.1

    def test_excision_code_and_sk_range(self, tmp_path):
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main, build_parser

        args = build_parser().parse_args(
            ["x", "-2", "n256:c4.5", "--skz_start", "1", "--skz_end", "3"])
        assert args.excision == "n256:c4.5"
        raw = self._raw(tmp_path)
        out = str(tmp_path / "e.npz")
        rc = main([raw, *self.HDR, "-c", "0.005", "-F", "4", "-D", "3",
                   "-b", "16", "-O", out, "-q", "-2", "n256,c4.5",
                   "--skz", "--skzm", "256", "--skz_start", "1",
                   "--skz_end", "3"])
        assert rc == 0

    def test_excision_fixed_token(self):
        """-2 fixed selects plain BitTable 2-bit levels (no JA98)."""
        from dspsr_jax.apps.dspsr_app import build_parser

        args = build_parser().parse_args(["x", "-2", "fixed"])
        assert args.excision == "fixed"
        # the token maps into FoldConfig.dynamic_twobit=False (parser-level
        # check; the pipeline behaviour is covered by the fixed 2-bit case
        # of test_golden.py)

    def test_cepoch_moves_the_peak(self, tmp_path):
        """--cepoch shifts phase zero: folding the same pulse train with a
        reference epoch offset by half a period rotates the profile by
        half a turn."""
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        rng = np.random.default_rng(1)
        ndat = 1 << 16
        t = np.arange(ndat) / 1e6
        noise = rng.normal(0, 10, (ndat, 2))
        noise[(t % 0.004) < 0.0004] *= 5.0
        raw = str(tmp_path / "cep.raw")
        with open(raw, "wb") as f:
            f.write(np.clip(np.round(noise + 127.5), 0, 255)
                    .astype(np.uint8).tobytes())
        peaks = []
        # MJD of UTC_START, and the same plus half a period
        base = 55299.0871527777777
        for i, cep in enumerate([base, base + 0.002 / 86400.0]):
            out = str(tmp_path / f"cep{i}.npz")
            rc = main([raw, *self.HDR, "-c", "0.004", "-F", "4", "-D", "1",
                       "-b", "32", "-O", out, "-q",
                       "--cepoch", f"{cep:.12f}"])
            assert rc == 0
            z = np.load(out, allow_pickle=False)
            prof = z["profiles"][0].sum(axis=(0, 1))
            peaks.append(int(np.argmax(prof)))
        shift = (peaks[0] - peaks[1]) % 32
        assert abs(shift - 16) <= 2, peaks

    def test_single_pulse_and_nsub(self, tmp_path):
        import os
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        raw = self._raw(tmp_path, 1 << 17)
        out = str(tmp_path / "sp.npz")
        rc = main([raw, *self.HDR, "-c", "0.004", "-F", "4", "-D", "1",
                   "-b", "16", "-O", out, "-q", "-s", "--nsub", "2"])
        assert rc == 0
        parts = sorted(p for p in os.listdir(tmp_path)
                       if p.startswith("sp_") and p.endswith(".npz"))
        assert len(parts) >= 2  # single pulses split 2 per archive
        z = np.load(tmp_path / parts[0], allow_pickle=False)
        assert z["profiles"].shape[0] == 2

    def test_predictors_file(self, tmp_path):
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        raw = self._raw(tmp_path)
        pf = tmp_path / "preds.txt"
        pf.write_text("0.007\n# comment\n0.003\n")
        out = str(tmp_path / "w.npz")
        rc = main([raw, *self.HDR, "-c", "0.005", "-F", "4", "-D", "1",
                   "-b", "16", "-O", out, "-q", "-w", str(pf)])
        assert rc == 0
        import os
        assert os.path.exists(str(tmp_path / "w_src1.npz"))
        assert os.path.exists(str(tmp_path / "w_src2.npz"))

    def test_inline_job(self, tmp_path):
        """-j CMD runs on each written archive (falls back to executing the
        temp script when psrsh is absent — verify the hook fires by making
        the 'command' a shell line the fallback executes)."""
        import os
        import numpy as np
        from dspsr_jax.apps.dspsr_app import main

        raw = self._raw(tmp_path)
        out = str(tmp_path / "j.npz")
        marker = str(tmp_path / "ran.txt")
        # without psrsh the temp script is executed directly with the
        # archive path; make it a shell script
        rc = main([raw, *self.HDR, "-c", "0.005", "-F", "4", "-D", "1",
                   "-b", "16", "-O", out, "-q",
                   "-j", f"#!/bin/sh\ntouch {marker}"])
        assert rc == 0


def test_sklimit_cli(capsys):
    """sklimit-jax prints the Pearson-IV SK thresholds sweep (reference
    Signal/Statistics/sklimit.C)."""
    from dspsr_jax.apps.diagnostics import sklimit
    from dspsr_jax.utils.stats import sk_limits

    assert sklimit(["-m", "128", "-M", "256", "-s", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3  # header + M=128 + M=256
    m128 = out[1].split()
    t = sk_limits(128, 3.0)
    assert abs(float(m128[2]) - t.lower) < 1e-6
    assert abs(float(m128[3]) - t.upper) < 1e-6
