"""DADA-style ASCII header parsing and formatting.

Equivalent of the reference's ``ascii_header.c`` + ``ASCIIObservation``
(``Kernel/Classes/ASCIIObservation.C:82-423``): a flat ``KEY value`` text
header (typically 4096 bytes, NUL/space padded) carrying the observation
metadata, followed (in a DADA file) by raw packed samples.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from ..observation import Observation, Signal
from ..timing.mjd import MJD

DEFAULT_HEADER_SIZE = 4096


def parse_ascii_header(text: str) -> Dict[str, str]:
    """Parse ``KEY value  # comment`` lines into a dict (ascii_header_get)."""
    out: Dict[str, str] = {}
    for line in text.split("\n"):
        line = line.split("#", 1)[0].strip().strip("\x00")
        if not line:
            continue
        toks = line.split(None, 1)
        if len(toks) == 2:
            out[toks[0]] = toks[1].strip()
        elif len(toks) == 1:
            out[toks[0]] = ""
    return out


def format_ascii_header(keys: Dict[str, str], size: int = DEFAULT_HEADER_SIZE) -> bytes:
    body = "".join(f"{k} {v}\n" for k, v in keys.items())
    data = body.encode()
    if len(data) > size:
        raise ValueError(f"header too large: {len(data)} > {size}")
    return data + b"\x00" * (size - len(data))


def observation_from_header(hdr: Dict[str, str]) -> Observation:
    """Build an Observation from DADA header keys.

    Key set and defaults follow ``ASCIIObservation::load``
    (``Kernel/Classes/ASCIIObservation.C:82-423``): required BW, FREQ, NPOL,
    NBIT, TSAMP, UTC_START; NDIM defaults 1, NCHAN defaults 1.
    TSAMP is in microseconds; rate = 1e6/TSAMP / (state==Nyquist ? 1 : 1)
    (the reference stores rate in samples/sec of the stored sample type).
    """
    obs = Observation()
    g = hdr.get

    obs.nchan = int(g("NCHAN", 1))
    obs.npol = int(g("NPOL", 1))
    obs.ndim = int(g("NDIM", 1))
    obs.nbit = int(g("NBIT", 8))

    obs.centre_frequency = float(g("FREQ", 0.0))
    obs.bandwidth = float(g("BW", 0.0))

    tsamp_us = float(g("TSAMP", 0.0))
    if tsamp_us > 0:
        obs.rate = 1e6 / tsamp_us

    utc = g("UTC_START")
    if utc:
        obs.start_time = MJD.from_utc(utc)
    elif g("MJD_START"):
        obs.start_time = MJD.from_mjd(float(g("MJD_START")))
    # sub-second start offset (DADA PICOSECONDS convention)
    if g("PICOSECONDS"):
        obs.start_time = obs.start_time + float(g("PICOSECONDS")) * 1e-12

    obs.source = g("SOURCE", "")
    obs.telescope = g("TELESCOPE", "")
    obs.receiver = g("RECEIVER", "")
    obs.instrument = g("INSTRUMENT", "")
    obs.mode = g("MODE", "")
    if g("CALFREQ"):
        obs.calfreq = float(g("CALFREQ"))
    if g("DM"):
        obs.dispersion_measure = float(g("DM"))
    if g("RM"):
        obs.rotation_measure = float(g("RM"))

    # state: NDIM==2 -> Analytic complex voltages; NDIM==1 undetected -> Nyquist
    state = g("STATE", "")
    if state:
        obs.state = Signal(state)
    elif obs.ndim == 2:
        obs.state = Signal.ANALYTIC
    elif obs.npol == 4:
        obs.state = Signal.COHERENCE
    else:
        obs.state = Signal.NYQUIST

    if g("DSB"):
        obs.dual_sideband = bool(int(g("DSB")))

    obs.obs_offset = int(g("OBS_OFFSET", 0))
    # offset the start time by OBS_OFFSET bytes worth of samples
    if obs.obs_offset and obs.rate > 0:
        bps = obs.nbytes_per_sample
        if bps > 0:
            obs.start_time = obs.start_time + (obs.obs_offset / bps) / obs.rate

    ndat = g("NDAT")
    if ndat:
        obs.ndat = int(ndat)

    return obs


def header_from_observation(obs: Observation, extra: Dict[str, str] | None = None,
                            instrument: str | None = None) -> Dict[str, str]:
    """Inverse of :func:`observation_from_header` (ASCIIObservation::unload)."""
    tsamp_us = 1e6 / obs.rate if obs.rate > 0 else 0.0
    # UTC_START carries whole seconds; the fractional second goes into the
    # PICOSECONDS key (DADA convention)
    whole = MJD(obs.start_time.days, math.floor(obs.start_time.secs))
    picos = (obs.start_time.secs - math.floor(obs.start_time.secs)) * 1e12
    utc = _format_utc(whole)
    keys = {
        "HDR_VERSION": "1.0",
        "HDR_SIZE": str(DEFAULT_HEADER_SIZE),
        "TELESCOPE": obs.telescope or "unknown",
        "RECEIVER": obs.receiver or "unknown",
        "INSTRUMENT": instrument or obs.instrument or "dspsr_jax",
        "SOURCE": obs.source or "unknown",
        "MODE": obs.mode or "PSR",
        "FREQ": repr(obs.centre_frequency),
        "BW": repr(obs.bandwidth),
        "NCHAN": str(obs.nchan),
        "NPOL": str(obs.npol),
        "NDIM": str(obs.ndim),
        "NBIT": str(obs.nbit),
        "TSAMP": repr(tsamp_us),
        "UTC_START": utc,
        "PICOSECONDS": str(int(round(picos))),
        "OBS_OFFSET": str(obs.obs_offset),
        "STATE": obs.state.value,
    }
    if obs.dispersion_measure:
        keys["DM"] = repr(obs.dispersion_measure)
    if obs.calfreq:
        keys["CALFREQ"] = repr(obs.calfreq)
    if extra:
        keys.update(extra)
    return keys


def _format_utc(t: MJD) -> str:
    """MJD -> YYYY-MM-DD-HH:MM:SS (whole seconds)."""
    jdn = t.days + 2400001
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    secs = int(round(t.secs))  # callers pass whole seconds
    hh, rem = divmod(secs, 3600)
    mm, ss = divmod(rem, 60)
    return f"{year:04d}-{month:02d}-{day:02d}-{hh:02d}:{mm:02d}:{ss:02d}"


def read_dada_header(path: str) -> Tuple[Dict[str, str], int]:
    """Read the ASCII header of a DADA file; returns (keys, header_size)."""
    with open(path, "rb") as f:
        probe = f.read(DEFAULT_HEADER_SIZE)
        hdr = parse_ascii_header(probe.decode("latin-1"))
        size = int(hdr.get("HDR_SIZE", DEFAULT_HEADER_SIZE))
        if size > len(probe):
            probe += f.read(size - len(probe))
            hdr = parse_ascii_header(probe[:size].decode("latin-1"))
    return hdr, size
