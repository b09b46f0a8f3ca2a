"""PSRFITS output: fold-mode archives and search-mode files.

Equivalent of the reference's PSRCHIVE ``Pulsar::Archive`` unloading
(``Signal/Pulsar/Archiver.C``) and the ``digifits`` search-mode writer
(``Signal/General/LoadToFITS.C`` + ``Kernel/Formats/fits``): writes the
PSRFITS layout (Hotan, van Straten & Manchester 2004) — a primary HDU with
observation keywords and a SUBINT binary table.

Fold mode: one row per subintegration; DATA is int16[nbin*nchan*npol] with
per-(chan,pol) DAT_SCL/DAT_OFFS; profiles are hit-normalized before scaling
(``Archiver.C:407-773``).

Search mode: one row per block of NSBLK samples; DATA is uint8 (1/2/4/8-bit
packed, channel fastest).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

import numpy as np

from .fits import FitsWriter
from ..observation import Observation

if TYPE_CHECKING:
    from ..models.load_to_fold import FoldResult


def _primary_cards(obs: Observation, obs_mode: str) -> List[tuple]:
    imjd = obs.start_time.days
    smjd = int(obs.start_time.secs)
    offs = obs.start_time.secs - smjd
    return [
        ("HDRVER", "6.1", "Header version"),
        ("FITSTYPE", "PSRFITS", "FITS definition for pulsar data"),
        ("OBSERVER", "dspsr_jax", ""),
        ("PROJID", "", ""),
        ("TELESCOP", obs.telescope or "unknown", ""),
        ("FRONTEND", obs.receiver or "unknown", ""),
        ("BACKEND", obs.instrument or "dspsr_jax", ""),
        ("OBS_MODE", obs_mode, "(PSR, CAL, SEARCH)"),
        ("SRC_NAME", obs.source or "unknown", ""),
        ("OBSFREQ", float(obs.centre_frequency), "[MHz] centre frequency"),
        ("OBSBW", float(obs.bandwidth), "[MHz] bandwidth"),
        ("OBSNCHAN", int(obs.nchan), "number of channels"),
        ("FD_POLN", "LIN" if obs.basis.value == "Linear" else "CIRC", ""),
        ("STT_IMJD", imjd, "start MJD (day)"),
        ("STT_SMJD", smjd, "start second"),
        ("STT_OFFS", float(offs), "start fractional second"),
    ]


def save_psrfits_fold(path: str, result: "FoldResult") -> None:
    """Write a fold-mode PSRFITS archive (Archiver::unload equivalent)."""
    obs = result.obs
    nsub = result.profiles.shape[0]
    nchan, npol, nbin = obs.nchan, obs.npol, result.nbin

    prof = result.normalized()  # [nsub, nchan, npol, nbin]
    freqs = np.array([obs.centre_frequency_of(i) for i in range(nchan)])

    # int16 scaling per (sub, chan, pol)
    lo = prof.min(axis=-1)  # [nsub, nchan, npol]
    hi = prof.max(axis=-1)
    scl = np.maximum((hi - lo) / 65530.0, 1e-30)
    offsv = (hi + lo) / 2.0
    q = np.round((prof - offsv[..., None]) / scl[..., None]).astype(np.int16)

    tsub = np.asarray(result.integration_length, np.float64)
    # gap-aware subint offsets: each subint's TRUE data-start epoch relative
    # to the observation start, plus half its integration (the reference
    # computes boundaries in TimeDivide rather than cumsumming lengths,
    # Signal/Pulsar/TimeDivide.C)
    if result.epochs and len(result.epochs) == nsub:
        starts = np.array([e - obs.start_time for e in result.epochs])
        offs_sub = starts + tsub / 2.0
    else:
        offs_sub = np.cumsum(tsub) - tsub / 2.0

    cols = [
        ("TSUBINT", "1D", "s", tsub),
        ("OFFS_SUB", "1D", "s", offs_sub),
        ("PERIOD", "1D", "s", np.full(nsub, result.folding_period)),
        ("DAT_FREQ", f"{nchan}D", "MHz", np.tile(freqs, (nsub, 1))),
        ("DAT_WTS", f"{nchan}E", "",
         np.asarray(result.hits.mean(axis=-1), np.float32)),
        ("DAT_OFFS", f"{nchan * npol}E", "",
         offsv.reshape(nsub, nchan * npol).astype(np.float32)),
        ("DAT_SCL", f"{nchan * npol}E", "",
         scl.reshape(nsub, nchan * npol).astype(np.float32)),
        # PSRFITS fold DATA order: (NBIN, NCHAN, NPOL) with bin fastest
        ("DATA", f"{nbin * nchan * npol}I", "",
         np.transpose(q, (0, 2, 1, 3)).reshape(nsub, npol * nchan * nbin)),
    ]
    extra = [
        ("NBIN", nbin, "number of phase bins"),
        ("NCHAN", nchan, ""),
        ("NPOL", npol, ""),
        ("POL_TYPE", _pol_type(obs), ""),
        ("NBITS", 16, ""),
        ("CHAN_BW", float(obs.chan_bandwidth), "[MHz]"),
        ("DM", float(result.dispersion_measure), "[pc cm-3]"),
        ("TBIN", float(result.folding_period / max(nbin, 1)), "[s]"),
        ("NSBLK", 1, ""),
        ("EPOCHS", "MIDTIME", ""),
    ]
    with open(path, "wb") as f:
        w = FitsWriter(f)
        w.write_primary(_primary_cards(obs, "PSR"))
        if result.signal_path is not None:
            _write_history(w, result)
        if result.digitizer_counts is not None:
            # DIG_CNTS-style extension (PSRCHIVE DigitiserCounts)
            dc = np.asarray(result.digitizer_counts, np.int64)
            w.write_bintable("DIG_CNTS", [
                ("DATA", f"{len(dc)}K", "", dc.reshape(1, -1)),
            ], [("NLEV", len(dc), "digitizer states"),
                ("DIGLEV", "FIX", "")])
        if result.passband is not None:
            _write_bandpass(w, result)
        if getattr(result, "ephemeris", None) is not None:
            _write_psrparam(w, result.ephemeris)
        _write_polyco(w, getattr(result, "predictor", None))
        w.write_bintable("SUBINT", cols, extra)


def _write_bandpass(w: "FitsWriter", result: "FoldResult") -> None:
    """PSRFITS BANDPASS extension: the integrated pre-detection bandpass
    (role of the reference's Passband archive extension,
    ``Signal/Pulsar/ArchiverExtensions.C``)."""
    pb = np.asarray(result.passband, np.float64)  # [nchan, npol, nres]
    nchan, npol, nres = pb.shape
    flat = pb.transpose(1, 0, 2).reshape(1, npol * nchan * nres)
    scale = flat.max() or 1.0
    # DATA stores round(v/scale*65535 - 32768) in int16; a reader applying
    # the PSRFITS convention v = offs + scl*data therefore needs
    # offs = 32768 * scale / 65535 to recover the bandpass values exactly
    w.write_bintable("BANDPASS", [
        ("DAT_OFFS", f"{npol}E", "",
         np.full((1, npol), 32768.0 * scale / 65535.0, np.float32)),
        ("DAT_SCL", f"{npol}E", "",
         np.full((1, npol), scale / 65535.0, np.float32)),
        ("DATA", f"{npol * nchan * nres}I", "",
         np.round(flat / scale * 65535.0 - 32768.0).astype(np.int16)),
    ], [("NCH_ORIG", nchan * nres, "original channels"),
        ("NPOL", npol, "")])


def _write_psrparam(w: "FitsWriter", ephemeris) -> None:
    """PSRFITS PSRPARAM extension: the pulsar ephemeris, one parameter line
    per row (what PSRCHIVE stores from Parameters)."""
    lines = []
    try:
        items = ephemeris.items() if hasattr(ephemeris, "items") else \
            ephemeris.params.items()
    except AttributeError:
        items = []
    for k, v in items:
        lines.append(f"{k:<12s} {v}")
    if not lines:
        return
    w.write_bintable("PSRPARAM", [
        ("PARAM", "128A", "",
         np.array([ln[:128].ljust(128) for ln in lines], dtype="S128")),
    ], [])


def _write_polyco(w: "FitsWriter", predictor) -> None:
    """PSRFITS POLYCO extension from a TEMPO polyco predictor (the reference
    Archiver attaches the polycos used for folding)."""
    from ..timing.polyco import Polyco

    if not isinstance(predictor, Polyco):
        return
    blocks = predictor.blocks
    n = len(blocks)
    ncoef = max(b.ncoef for b in blocks)
    coefs = np.zeros((n, ncoef), np.float64)
    for i, b in enumerate(blocks):
        coefs[i, : b.ncoef] = b.coefs
    w.write_bintable("POLYCO", [
        ("DATE_PRO", "24A", "", np.array([b" " * 24] * n, dtype="S24")),
        ("POLYVER", "16A", "", np.array([b"tempo"] * n, dtype="S16")),
        ("NSPAN", "1I", "min",
         np.array([int(b.span_minutes) for b in blocks], np.int16)),
        ("NCOEF", "1I", "", np.array([b.ncoef for b in blocks], np.int16)),
        ("NPBLK", "1I", "", np.full(n, n, np.int16)),
        ("NSITE", "8A", "",
         np.array([str(b.obs)[:8].ljust(8) for b in blocks], dtype="S8")),
        ("REF_FREQ", "1D", "MHz",
         np.array([b.obsfreq for b in blocks], np.float64)),
        ("PRED_PHS", "1D", "",
         np.array([getattr(b, "binary_phase", 0.0) or 0.0 for b in blocks])),
        ("REF_MJD", "1D", "",
         np.array([b.tmid.days + b.tmid.fracday() for b in blocks])),
        ("REF_PHS", "1D", "", np.array([b.rphase % 1.0 for b in blocks])),
        ("REF_F0", "1D", "Hz", np.array([b.f0 for b in blocks])),
        ("LGFITERR", "1D", "",
         np.array([b.log10_rms for b in blocks])),
        ("COEFF", f"{ncoef}D", "", coefs),
    ], [])


def _write_history(w: "FitsWriter", result: "FoldResult") -> None:
    """PSRFITS HISTORY table: one row per op of the recorded signal path
    (the role of PSRCHIVE's ProcHistory extension, which the reference
    Archiver fills from dspReduction/SignalPath)."""
    import json

    sp = result.signal_path
    obs = result.obs
    nrows = len(sp)

    def cmd(rec):
        d = dict(rec)
        name = d.pop("op", "?")
        args = json.dumps(d, default=str, separators=(",", ":"))
        return f"{name} {args}"[:256].ljust(256)

    cols = [
        ("DATE_PRO", "24A", "",
         np.array([" " * 24] * nrows, dtype="S24")),
        ("PROC_CMD", "256A", "",
         np.array([cmd(r) for r in sp], dtype="S256")),
        ("NCHAN", "1J", "", np.full(nrows, obs.nchan, np.int32)),
        ("NBIN", "1J", "", np.full(nrows, result.nbin, np.int32)),
        ("NPOL", "1J", "", np.full(nrows, obs.npol, np.int32)),
        ("NSUB", "1J", "",
         np.full(nrows, result.profiles.shape[0], np.int32)),
        ("CTR_FREQ", "1D", "MHz",
         np.full(nrows, obs.centre_frequency, np.float64)),
        ("CHAN_BW", "1D", "MHz",
         np.full(nrows, obs.chan_bandwidth, np.float64)),
        ("DM", "1D", "", np.full(nrows, result.dispersion_measure,
                                 np.float64)),
    ]
    w.write_bintable("HISTORY", cols, [])


def _pol_type(obs: Observation) -> str:
    from ..observation import Signal

    return {
        Signal.INTENSITY: "AA+BB",
        Signal.PPQQ: "AABB",
        Signal.COHERENCE: "AABBCRCI",
        Signal.STOKES: "IQUV",
    }.get(obs.state, "AA+BB")


class PsrfitsSearchWriter:
    """Streaming search-mode PSRFITS writer (digifits equivalent,
    ``Signal/General/LoadToFITS.C``).

    Packs detected, requantized blocks into NSBLK-sample subint rows and
    **streams each row to disk as it completes** — memory is bounded by one
    row regardless of observation length (the reference relies on cfitsio
    row appends the same way).  NAXIS2 is patched at close.
    """

    def __init__(self, path: str, obs: Observation, nbits: int = 8,
                 nsblk: int = 4096):
        self.path = path
        self.obs = obs
        self.nbits = nbits
        self.nsblk = nsblk
        self._carry = np.zeros(0, np.uint8)
        self.row_bytes = nsblk * obs.nchan * obs.npol * nbits // 8
        self.nrows = 0

        nchan, npol = obs.nchan, obs.npol
        self._freqs_be = np.array(
            [obs.centre_frequency_of(i) for i in range(nchan)],
            ">f8").tobytes()
        self._wts_be = np.ones(nchan, ">f4").tobytes()
        self._offs_be = np.zeros(nchan * npol, ">f4").tobytes()
        self._scl_be = np.ones(nchan * npol, ">f4").tobytes()
        self._tsub = self.nsblk / obs.rate

        self._f = open(self.path, "w+b")
        self._w = FitsWriter(self._f)
        self._w.write_primary(_primary_cards(obs, "SEARCH"))
        cols = [
            ("TSUBINT", "1D", "s", 8),
            ("OFFS_SUB", "1D", "s", 8),
            ("DAT_FREQ", f"{nchan}D", "MHz", 8 * nchan),
            ("DAT_WTS", f"{nchan}E", "", 4 * nchan),
            ("DAT_OFFS", f"{nchan * npol}E", "", 4 * nchan * npol),
            ("DAT_SCL", f"{nchan * npol}E", "", 4 * nchan * npol),
            ("DATA", f"{self.row_bytes}B", "", self.row_bytes),
        ]
        extra = [
            ("NBIN", 1, ""),
            ("NCHAN", nchan, ""),
            ("NPOL", npol, ""),
            ("POL_TYPE", _pol_type(obs), ""),
            ("NBITS", self.nbits, ""),
            ("CHAN_BW", float(obs.chan_bandwidth), "[MHz]"),
            ("TBIN", float(1.0 / obs.rate), "[s] sample time"),
            ("NSBLK", self.nsblk, "samples per row"),
        ]
        self._w.begin_bintable("SUBINT", cols, extra)

    def _emit_row(self, data: np.ndarray) -> None:
        offs = (self.nrows + 0.5) * self._tsub
        row = (np.array(self._tsub, ">f8").tobytes()
               + np.array(offs, ">f8").tobytes()
               + self._freqs_be + self._wts_be + self._offs_be
               + self._scl_be + data.tobytes())
        self._w.write_row(row)
        self.nrows += 1

    def write_block(self, packed: np.ndarray) -> None:
        buf = np.concatenate([self._carry, packed.ravel()])
        nrows = len(buf) // self.row_bytes
        for r in range(nrows):
            self._emit_row(buf[r * self.row_bytes : (r + 1) * self.row_bytes])
        self._carry = buf[nrows * self.row_bytes :]

    def close(self) -> None:
        if self._f is None:
            return
        if self._carry.size:
            pad = np.zeros(self.row_bytes - self._carry.size, np.uint8)
            self._emit_row(np.concatenate([self._carry, pad]))
            self._carry = np.zeros(0, np.uint8)
        self._w.end_bintable()
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
