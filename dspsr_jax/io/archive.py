"""Fold-mode archive output.

Equivalent of the reference ``dsp::Archiver`` + PSRCHIVE ``Pulsar::Archive``
(``Signal/Pulsar/Archiver.C``): persists folded phase-resolved profiles with
enough metadata to analyse (and to compare against reference archives).

v1 container: a single ``.npz`` with a documented schema ("archive-lite");
a PSRFITS fold-mode writer is layered on in io/psrfits.py.

Schema (all arrays little-endian):
  profiles  float32[nsub, nchan, npol, nbin]  raw accumulated sums
  hits      float32[nsub, nchan, nbin]        samples per bin
  epochs_mjd float64[nsub]                    epoch per subint (MJD days)
  lengths   float64[nsub]                     integration seconds per subint
  freqs_mhz float64[nchan]                    channel centre frequencies
  meta      str(json)                         source/dm/period/state/...
"""

from __future__ import annotations

import json
from dataclasses import asdict
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..models.load_to_fold import FoldResult


def filename_epoch(result, ext: str = "npz") -> str:
    """Reference filename convention (``FilenameEpoch``,
    ``LoadToFold1.C:1271-1328``): <source>_<UTC start>.<ext>."""
    t = result.epochs[0] if result.epochs else result.obs.start_time
    mjd = t.in_days()
    src = result.obs.source or "unknown"
    return f"{src}_{mjd:.6f}.{ext}"


def save_archive(path: str, result: "FoldResult") -> None:
    """Route on extension: .npz archive-lite, .sf/.fits/.rf PSRFITS
    (reference -a archive class selection, ``Archiver.C:162``)."""
    if path.endswith((".sf", ".fits", ".rf", ".ar")):
        from .psrfits import save_psrfits_fold

        save_psrfits_fold(path, result)
        return
    _save_npz(path, result)


def _save_npz(path: str, result: "FoldResult") -> None:
    obs = result.obs
    freqs = np.array([obs.centre_frequency_of(i) for i in range(obs.nchan)])
    meta = {
        "source": obs.source,
        "telescope": obs.telescope,
        "state": obs.state.value,
        "centre_frequency": obs.centre_frequency,
        "bandwidth": obs.bandwidth,
        "nbin": result.nbin,
        "dispersion_measure": result.dispersion_measure,
        "folding_period": result.folding_period,
        "npol": obs.npol,
        "nchan": obs.nchan,
        "format": "dspsr_jax archive-lite v1",
    }
    if result.signal_path is not None:
        # op-chain provenance (reference SignalPath/dspReduction extension)
        meta["signal_path"] = result.signal_path
    arrays = dict(
        profiles=result.profiles.astype(np.float32),
        hits=result.hits.astype(np.float32),
        epochs_mjd=np.array([e.in_days() for e in result.epochs]),
        lengths=np.asarray(result.integration_length, np.float64),
        freqs_mhz=freqs,
        meta=json.dumps(meta),
    )
    if result.digitizer_counts is not None:
        # DigitiserCounts equivalent (reference ArchiverExtensions.C)
        arrays["digitizer_counts"] = np.asarray(result.digitizer_counts,
                                                np.int64)
    if getattr(result, "pdmp_stats", None) is not None:
        # -Y pdmp extras (reference Stats op moments)
        arrays["pdmp_stats"] = np.asarray(result.pdmp_stats, np.float64)
        arrays["pdmp_nsamp"] = np.asarray(result.pdmp_nsamp, np.int64)
    np.savez_compressed(path, **arrays)


def load_archive(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files if k != "meta"}
        out["meta"] = json.loads(str(z["meta"]))
    return out
