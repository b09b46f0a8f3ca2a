"""Block data sources: the Input layer.

Equivalent of the reference Input hierarchy (``Kernel/Classes/dsp/Input.h``,
``Seekable.h``, ``File.h``, ``MultiFile.h``, ``DummyFile.h``): sources
deliver raw packed byte blocks plus the Observation describing them.

Unlike the reference's mutable load(BitSeries) protocol, sources here expose
a simple positional read: ``read_samples(start_sample, nsamp) -> bytes`` —
overlap handling lives in the pipeline's block planner (which re-reads the
overlap region; the OS page cache plays the role of the reference's
``Seekable::recycle_data`` ring buffer).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..observation import Observation, Signal
from .dada import read_dada_header, observation_from_header

_REGISTRY: List[type] = []


def register_format(cls):
    """Class decorator enrolling a Source in the probe registry
    (equivalent of ``File_registry.C``)."""
    _REGISTRY.append(cls)
    return cls


def open_source(path: str, **kw) -> "Source":
    """Probe every registered format's ``is_valid`` (reference
    ``File::create``, ``Kernel/Classes/File.C``)."""
    for cls in _REGISTRY:
        if cls.is_valid(path):
            return cls(path, **kw)
    raise ValueError(f"no registered format recognises {path!r}")


class Source:
    """Abstract block source."""

    obs: Observation

    def bytes_per_sample_exact(self) -> int:
        """Bytes per time sample; must be integral for byte-addressable seeks."""
        bps = self.obs.nbytes_per_sample
        if bps != int(bps):
            raise ValueError(
                f"non-integral bytes/sample ({bps}); sub-byte multi-sample "
                "framing not yet supported"
            )
        return int(bps)

    @property
    def total_samples(self) -> int:
        raise NotImplementedError

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        """Return uint8[nsamp * bytes_per_sample] (zero-padded past EOD)."""
        raise NotImplementedError

    def end_of_data(self, start: int) -> bool:
        return start >= self.total_samples


@register_format
class DADAFile(Source):
    """Single DADA file: ASCII header + raw packed samples
    (reference ``Kernel/Classes/DADAFile.C``)."""

    def __init__(self, path: str):
        self.path = path
        hdr, hdr_size = read_dada_header(path)
        self.obs = observation_from_header(hdr)
        self.header = hdr
        self.header_bytes = hdr_size
        data_bytes = os.path.getsize(path) - hdr_size
        bps = self.bytes_per_sample_exact()
        self._total = data_bytes // bps
        if self.obs.ndat and self.obs.ndat < self._total:
            self._total = self.obs.ndat
        self.obs = self.obs.replace(ndat=self._total)

    @staticmethod
    def is_valid(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                head = f.read(256)
            if head[:5] == b"DUMMY":  # synthetic header -> DummySource
                return False
            probe = head.decode("latin-1", "replace")
            return "HDR_VERSION" in probe or "HDR_SIZE" in probe
        except OSError:
            return False

    @property
    def total_samples(self) -> int:
        return self._total

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        out = np.zeros(nsamp * bps, np.uint8)
        if start >= self._total:
            return out
        navail = min(nsamp, self._total - start)
        with open(self.path, "rb") as f:
            f.seek(self.header_bytes + start * bps)
            buf = f.read(navail * bps)
        out[: len(buf)] = np.frombuffer(buf, np.uint8)
        return out


@register_format
class DummySource(Source):
    """Synthetic source driven only by a header: fake data for benchmarks
    (reference ``DummyFile``, ``Kernel/Classes/dsp/DummyFile.h`` — 'Make fake
    data for benchmark purposes'; the DUMMY instrument in
    ``Benchmark/header.dada``).

    Generates reproducible pseudo-random bytes per block (cheap xor-shift on
    the sample index, not cryptographic), so benchmark runs need no disk.
    """

    def __init__(self, path_or_header, noise: bool = True):
        if isinstance(path_or_header, Observation):
            self.obs = path_or_header
        else:
            hdr, _ = read_dada_header(path_or_header)
            self.obs = observation_from_header(hdr)
        self.noise = noise
        self._total = self.obs.ndat or (1 << 62)

    @staticmethod
    def is_valid(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                return f.read(5) == b"DUMMY"
        except OSError:
            return False

    @property
    def total_samples(self) -> int:
        return self._total

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        n = nsamp * bps
        if not self.noise:
            return np.zeros(n, np.uint8)
        # deterministic bytes from the absolute byte index
        idx = (np.arange(n, dtype=np.uint64) + np.uint64(start * bps))
        h = idx * np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
        return (h & np.uint64(0xFF)).astype(np.uint8)


def device_noise_bytes(start_byte, nbytes: int):
    """Pseudo-noise uint8 generated ON DEVICE — the ``DummyFile``
    fake-data-for-benchmark role (``Kernel/Classes/dsp/DummyFile.h``) without
    a host->device transfer in the measured path.

    JAX computes in 32-bit integers unless 64-bit mode is on, so this uses
    a 32-bit multiply-xorshift mix (distinct stream from the host-side
    :class:`DummySource` hash; identical statistics).  ``nbytes`` must be
    static; ``start_byte`` may be traced.
    """
    import jax
    import jax.numpy as jnp

    i = (jax.lax.broadcasted_iota(jnp.uint32, (nbytes, 1), 0).reshape(nbytes)
         + jnp.uint32(start_byte))
    h = i * jnp.uint32(2654435761)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 13)
    return (h & jnp.uint32(0xFF)).astype(jnp.uint8)


class RawFileSource(Source):
    """Headerless raw data file + externally supplied Observation
    (reference ``CommandLineHeader``: ``dspsr --header KEY=VAL ...``)."""

    def __init__(self, path: str, obs: Observation, header_bytes: int = 0):
        self.path = path
        self.obs = obs
        self.header_bytes = header_bytes
        bps = self.bytes_per_sample_exact()
        self._total = (os.path.getsize(path) - header_bytes) // bps
        if obs.ndat and obs.ndat < self._total:
            self._total = obs.ndat
        self.obs = obs.replace(ndat=self._total)

    @staticmethod
    def is_valid(path) -> bool:
        return False  # explicit construction only

    @property
    def total_samples(self) -> int:
        return self._total

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        out = np.zeros(nsamp * bps, np.uint8)
        if start >= self._total:
            return out
        navail = min(nsamp, self._total - start)
        with open(self.path, "rb") as f:
            f.seek(self.header_bytes + start * bps)
            buf = f.read(navail * bps)
        out[: len(buf)] = np.frombuffer(buf, np.uint8)
        return out


class BlockFileSource(Source):
    """Data framed in fixed-size blocks with per-block headers/trailers
    (generic ``dsp::BlockFile``, ``Kernel/Classes/BlockFile.C``): only the
    payload bytes between each block's header and trailer are data.

    GUPPI RAW is the specialized variant (io/guppi.py); this generic form
    serves any fixed-framing capture format.
    """

    def __init__(self, path: str, obs: Observation, block_bytes: int,
                 block_header_bytes: int = 0, block_trailer_bytes: int = 0,
                 file_header_bytes: int = 0):
        self.path = path
        self.obs = obs
        self.block_bytes = block_bytes
        self.bh = block_header_bytes
        self.bt = block_trailer_bytes
        self.fh = file_header_bytes
        self.payload = block_bytes - block_header_bytes - block_trailer_bytes
        if self.payload <= 0:
            raise ValueError("block smaller than its header+trailer")
        bps = self.bytes_per_sample_exact()
        nbytes = os.path.getsize(path) - file_header_bytes
        nblocks = nbytes // block_bytes
        tail = nbytes - nblocks * block_bytes
        tail_payload = max(tail - block_header_bytes, 0) if tail > self.bh \
            else 0
        self._total = (nblocks * self.payload + tail_payload) // bps
        self.obs = obs.replace(ndat=self._total)

    @staticmethod
    def is_valid(path) -> bool:
        return False  # explicit construction only

    @property
    def total_samples(self) -> int:
        return self._total

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        a = start * bps
        need = nsamp * bps
        out = np.zeros(need, np.uint8)
        got = 0
        blk = a // self.payload
        off = a % self.payload
        with open(self.path, "rb") as f:
            while got < need:
                f.seek(self.fh + blk * self.block_bytes + self.bh + off)
                chunk = f.read(min(self.payload - off, need - got))
                if not chunk:
                    break
                out[got : got + len(chunk)] = np.frombuffer(chunk, np.uint8)
                got += len(chunk)
                blk += 1
                off = 0
        return out


def observation_from_presto_inf(path: str) -> Observation:
    """PRESTO ``.inf`` metadata reader (reference ``PrestoObservation`` /
    ``infodata.h``): key descriptions before '=' map onto Observation."""
    from .dada import observation_from_header
    from ..timing.mjd import MJD

    kv = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            desc, _, val = line.partition("=")
            kv[desc.strip().lower()] = val.strip()

    def find(*needles, default=None):
        for k, v in kv.items():
            if all(n in k for n in needles):
                return v
        return default

    nchan = int(find("number of channels", default="1"))
    tsamp = float(find("width of each time series bin", default="1e-6"))
    fbot = float(find("central freq of low channel", default="1400"))
    chan_bw = float(find("channel bandwidth", default="1"))
    mjd = float(find("epoch of observation", default="55000"))
    obs = Observation(
        nchan=nchan, npol=1, ndim=1,
        nbit=int(find("bits per sample", default="8") or 8),
        centre_frequency=fbot + 0.5 * chan_bw * (nchan - 1),
        bandwidth=chan_bw * nchan,
        rate=1.0 / tsamp,
        start_time=MJD(int(mjd), (mjd - int(mjd)) * 86400.0),
        state=Signal.INTENSITY,
        source=find("object being observed", default="") or "",
        telescope=find("telescope used", default="") or "",
        instrument=find("instrument used", default="") or "",
        dispersion_measure=float(find("dispersion measure", default="0")
                                 or 0.0),
    )
    return obs


def observation_from_keyvals(pairs) -> Observation:
    """Build an Observation from KEY=VAL strings (CommandLineHeader)."""
    from .dada import observation_from_header

    hdr = {}
    for p in pairs:
        if "=" not in p:
            raise ValueError(f"--header expects KEY=VAL, got {p!r}")
        k, v = p.split("=", 1)
        hdr[k.strip().upper()] = v.strip()
    return observation_from_header(hdr)


class MultiFile(Source):
    """Concatenate contiguous files into one logical stream
    (reference ``Kernel/Classes/MultiFile.C``)."""

    def __init__(self, paths: Sequence[str], force_contiguity: bool = False):
        if not paths:
            raise ValueError("no files")
        self.parts = [open_source(p) for p in paths]
        obs0 = self.parts[0].obs
        for prev, nxt in zip(self.parts, self.parts[1:]):
            if not force_contiguity and not prev.obs.contiguous_with(nxt.obs):
                raise ValueError(
                    f"files not contiguous: {prev!r} then {nxt!r} "
                    "(pass force_contiguity=True to override)"
                )
        self.obs = obs0.replace(ndat=sum(p.total_samples for p in self.parts))
        self._offsets = np.cumsum([0] + [p.total_samples for p in self.parts])

    @staticmethod
    def is_valid(path) -> bool:
        return False  # constructed explicitly, not probed

    @property
    def total_samples(self) -> int:
        return int(self._offsets[-1])

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        out = np.zeros(nsamp * bps, np.uint8)
        filled = 0
        while filled < nsamp:
            pos = start + filled
            if pos >= self.total_samples:
                break
            i = int(np.searchsorted(self._offsets, pos, side="right")) - 1
            local = pos - int(self._offsets[i])
            take = min(nsamp - filled, self.parts[i].total_samples - local)
            out[filled * bps : (filled + take) * bps] = self.parts[i].read_samples(
                local, take
            )
            filled += take
        return out


@register_format
class Multiplex(Source):
    """Round-robin packet interleave of several files into one stream
    (reference ``Kernel/Classes/Multiplex.C:145-221``: 8192-byte packets are
    taken from each file in turn — packet k of the logical stream comes from
    file ``k % nfiles`` at its own packet index ``k // nfiles``).

    Probe accepts an ASCII file listing valid data filenames, one per line
    (``Multiplex::is_valid``); construct directly with a list of paths
    otherwise.
    """

    PACKET = 8192  # bytes per interleave packet (Multiplex.C:156)

    def __init__(self, path_or_paths, packet_bytes: int = PACKET):
        if isinstance(path_or_paths, str):
            paths = self._read_list(path_or_paths)
        else:
            paths = list(path_or_paths)
        if not paths:
            raise ValueError("no files")
        self.parts = [open_source(p) for p in paths]
        self.packet = int(packet_bytes)
        obs0 = self.parts[0].obs
        bps = obs0.nbytes_per_sample
        if bps != int(bps):
            raise ValueError("Multiplex needs integral bytes/sample")
        # logical payload = sum of whole packets available in every file
        # (trailing partial packets end the stream, as the reference's
        # did_load < to_load -> end_of_data)
        self._file_packets = min(
            (p.total_samples * int(bps)) // self.packet for p in self.parts)
        total_bytes = self._file_packets * self.packet * len(self.parts)
        self.obs = obs0.replace(ndat=total_bytes // int(bps))

    @staticmethod
    def _read_list(path: str):
        with open(path, "r") as f:
            return [ln.strip() for ln in f if ln.strip()]

    @staticmethod
    def is_valid(path) -> bool:
        try:
            if os.path.getsize(path) > 65536:
                return False
            with open(path, "rb") as f:
                text = f.read().decode("ascii")
            lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
            return (len(lines) >= 2
                    and all(os.path.isfile(ln) for ln in lines))
        except (OSError, UnicodeDecodeError):
            return False

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        n = len(self.parts)
        b0 = start * bps
        nbytes = nsamp * bps
        out = np.zeros(nbytes, np.uint8)
        filled = 0
        while filled < nbytes:
            pos = b0 + filled
            pkt = pos // self.packet
            if pkt >= self._file_packets * n:
                break
            off = pos % self.packet
            ifile = pkt % n
            fpkt = pkt // n
            take = min(nbytes - filled, self.packet - off)
            # file byte range -> that file's samples
            fb0 = fpkt * self.packet + off
            s0, s1 = fb0 // bps, -(-(fb0 + take) // bps)
            chunk = self.parts[ifile].read_samples(s0, s1 - s0)
            a0 = fb0 - s0 * bps
            out[filled:filled + take] = chunk[a0:a0 + take]
            filled += take
        return out
