"""SignalPath provenance recording (reference dsp::SignalPath +
dspReduction/ProcHistory archive extensions, Kernel/Classes/dsp/SignalPath.h,
Signal/Pulsar/Archiver.C)."""

import numpy as np

from dspsr_jax.io.archive import save_archive, load_archive
from dspsr_jax.io.psrfits_in import load_psrfits_fold, _parse_headers_with_offsets
from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
from dspsr_jax.io.sources import open_source

from test_pipeline import synth_pulsar_dada, PERIOD, DM


def _fold(pulsar_path, **cfg_kw):
    cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                     block_parts=2, **cfg_kw)
    pipe = FoldPipeline(open_source(pulsar_path), cfg)
    return pipe, pipe.run()


def test_signal_path_records_op_chain(tmp_path):
    p = synth_pulsar_dada(str(tmp_path / "a.dada"), nsec=0.05)
    pipe, res = _fold(p, nchan=4, sk_enable=True)
    ops = [r["op"] for r in res.signal_path]
    assert ops == ["Source", "Unpack", "Dedispersion", "Filterbank",
                   "SpectralKurtosis", "Detection", "Fold"]
    by = {r["op"]: r for r in res.signal_path}
    assert by["Source"]["file"] == p
    assert by["Filterbank"]["nchan_subband"] == 4
    assert by["Filterbank"]["convolve_when"] == "During"
    assert by["Dedispersion"]["dm"] == DM
    assert by["Fold"]["nbin"] == res.nbin
    assert by["Fold"]["predictor"] == "FixedPeriodPredictor"


def test_signal_path_in_npz_meta(tmp_path):
    p = synth_pulsar_dada(str(tmp_path / "a.dada"), nsec=0.05)
    _, res = _fold(p)
    out = str(tmp_path / "a.npz")
    save_archive(out, res)
    meta = load_archive(out)["meta"]
    assert [r["op"] for r in meta["signal_path"]][-1] == "Fold"


def test_psrfits_history_table(tmp_path):
    p = synth_pulsar_dada(str(tmp_path / "a.dada"), nsec=0.05)
    _, res = _fold(p)
    out = str(tmp_path / "a.sf")
    save_archive(out, res)
    # archive still reads back fine with the extra HDU present
    arch = load_psrfits_fold(out)
    assert arch.profiles.shape[-1] == res.nbin
    # HISTORY extension exists with one row per op
    hdus = _parse_headers_with_offsets(out)
    hist = [h for h in hdus if h[0].get("EXTNAME", "").strip() == "HISTORY"]
    assert len(hist) == 1
    cards, off, nbytes = hist[0]
    assert int(cards["NAXIS2"]) == len(res.signal_path)
    raw = np.fromfile(out, np.uint8, offset=off, count=nbytes)
    rows = raw.reshape(int(cards["NAXIS2"]), int(cards["NAXIS1"]))
    # PROC_CMD column (offset 24, width 256) names each op
    cmds = [bytes(r[24:24 + 256]).decode().split()[0] for r in rows]
    assert cmds[0] == "Source" and cmds[-1] == "Fold"


def test_seek_seconds_skips_input(tmp_path):
    """-S equivalent: seek skips input and shifts the subint epoch."""
    p = synth_pulsar_dada(str(tmp_path / "s.dada"), nsec=0.5)
    cfg = FoldConfig(folding_period=PERIOD, dispersion_measure=DM,
                     block_parts=2)
    pipe_full = FoldPipeline(open_source(p), cfg)
    full = pipe_full.run()
    import dataclasses
    cfg_seek = dataclasses.replace(cfg, seek_seconds=0.25)
    pipe_seek = FoldPipeline(open_source(p), cfg_seek)
    seek = pipe_seek.run()
    assert 0 < seek.integration_length.sum() <= full.integration_length.sum()
    dt = (seek.epochs[0] - full.epochs[0])
    assert 0.2 < dt < 0.3  # epoch advanced by ~the seek


def test_digitizer_counts_recorded(tmp_path):
    """HistUnpacker stats -> DigitiserCounts archive extension."""
    p = synth_pulsar_dada(str(tmp_path / "d.dada"), nsec=0.3)
    _, res = _fold(p)
    dc = res.digitizer_counts
    assert dc is not None and dc.shape == (256,)
    # counts cover every consumed byte (8-bit input: one state per byte)
    nblocks_bytes = dc.sum()
    assert nblocks_bytes > 0
    # roughly gaussian codes around mid-scale: central mass dominates
    assert dc[96:160].sum() > 0.8 * nblocks_bytes
    out = str(tmp_path / "d.npz")
    save_archive(out, res)
    a = load_archive(out)
    np.testing.assert_array_equal(a["digitizer_counts"], dc)
    # PSRFITS DIG_CNTS extension round-trips
    sf = str(tmp_path / "d.sf")
    save_archive(sf, res)
    hdus = _parse_headers_with_offsets(sf)
    dig = [h for h in hdus if h[0].get("EXTNAME", "").strip() == "DIG_CNTS"]
    assert len(dig) == 1
    cards, off, nbytes = dig[0]
    vals = np.fromfile(sf, ">i8", offset=off, count=256)
    np.testing.assert_array_equal(vals, dc)


def test_repeat_soak_writes_sequence_archives(tmp_path, monkeypatch):
    """--repeat N reprocesses the input N times (reference --repeat,
    SingleThread.C:456-487)."""
    from dspsr_jax.apps.dspsr_app import main

    p = synth_pulsar_dada(str(tmp_path / "r.dada"), nsec=0.05)
    out = str(tmp_path / "r.npz")
    assert main([p, "-c", str(PERIOD), "-D", str(DM),
                 "--repeat", "2", "-O", out, "-q"]) == 0
    a0 = load_archive(out)
    a1 = load_archive(str(tmp_path / "r_r1.npz"))
    a2 = load_archive(str(tmp_path / "r_r2.npz"))
    # identical input + fresh accumulators -> identical profiles
    np.testing.assert_array_equal(a0["profiles"], a1["profiles"])
    np.testing.assert_array_equal(a1["profiles"], a2["profiles"])
