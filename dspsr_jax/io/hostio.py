"""ctypes bindings for the native host I/O runtime (native/hostio.cpp).

- :class:`PrefetchSource`: wraps any file-backed Source with a C++
  background-thread prefetcher (the reference's Seekable/IOManager
  double-buffering role) so disk reads overlap device compute.
- :class:`RingWriter` / :class:`RingReader`: POSIX shared-memory ring buffer
  for live capture (the psrdada ring role used by ``DADABuffer``; simplified
  protocol, not psrdada binary compatible).

The shared library is built by ``make -C native``; :func:`load_hostio`
builds it on demand and raises a clear error if no toolchain exists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..observation import Observation
from .dada import parse_ascii_header, observation_from_header, format_ascii_header
from .sources import Source

_LIB = None


def _native_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..", "native")


def load_hostio() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.join(_native_dir(), "libhostio.so")
    # built from native/hostio.cpp at first use; the lock keeps concurrent
    # processes (test workers) from loading a half-written library
    import fcntl

    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            subprocess.run(["make", "-C", _native_dir()], check=True,
                           capture_output=True)
    lib = ctypes.CDLL(so)
    lib.prefetch_open.restype = ctypes.c_void_p
    lib.prefetch_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.prefetch_next.restype = ctypes.c_int64
    lib.prefetch_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.prefetch_close.argtypes = [ctypes.c_void_p]

    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64]
    lib.ring_connect.restype = ctypes.c_void_p
    lib.ring_connect.argtypes = [ctypes.c_char_p]
    lib.ring_write_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64]
    lib.ring_read_header.restype = ctypes.c_int
    lib.ring_read_header.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_set_eod.argtypes = [ctypes.c_void_p]
    lib.ring_buf_bytes.restype = ctypes.c_int64
    lib.ring_buf_bytes.argtypes = [ctypes.c_void_p]
    lib.ring_hdr_bytes.restype = ctypes.c_int64
    lib.ring_hdr_bytes.argtypes = [ctypes.c_void_p]
    lib.ring_fill.restype = ctypes.c_int64
    lib.ring_fill.argtypes = [ctypes.c_void_p]
    lib.ring_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    # psrdada-architecture SysV hdu (data block at key, header at key+1)
    lib.dada_create.restype = ctypes.c_void_p
    lib.dada_create.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64]
    lib.dada_connect.restype = ctypes.c_void_p
    lib.dada_connect.argtypes = [ctypes.c_int]
    lib.dada_write_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64]
    lib.dada_read_header.restype = ctypes.c_int
    lib.dada_read_header.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.dada_push.restype = ctypes.c_int
    lib.dada_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_double]
    lib.dada_pop.restype = ctypes.c_int
    lib.dada_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_double]
    lib.dada_set_eod.argtypes = [ctypes.c_void_p]
    lib.dada_bufsz.restype = ctypes.c_int64
    lib.dada_bufsz.argtypes = [ctypes.c_void_p]
    lib.dada_nbufs.restype = ctypes.c_int64
    lib.dada_nbufs.argtypes = [ctypes.c_void_p]
    lib.dada_hdr_bufsz.restype = ctypes.c_int64
    lib.dada_hdr_bufsz.argtypes = [ctypes.c_void_p]
    lib.dada_fill.restype = ctypes.c_int64
    lib.dada_fill.argtypes = [ctypes.c_void_p]
    lib.dada_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _LIB = lib
    return lib


#: psrdada's default ring key (dada_def.h DADA_DEFAULT_BLOCK_KEY)
DADA_DEFAULT_BLOCK_KEY = 0xDADA


class PrefetchSource(Source):
    """Sequential block reader with native background prefetch.

    Serves the pipeline's fixed-stride access pattern: block b covers
    samples [b*stride, b*stride + block_samples).  Random access falls back
    to the inner source.
    """

    def __init__(self, inner, block_samples: int, stride_samples: int,
                 depth: int = 4):
        from .sources import DADAFile

        if not isinstance(inner, DADAFile):
            raise TypeError("PrefetchSource currently wraps DADAFile sources")
        self.inner = inner
        self.obs = inner.obs
        bps = inner.bytes_per_sample_exact()
        self.block_samples = block_samples
        self.stride_samples = stride_samples
        self._bps = bps
        self._lib = load_hostio()
        self._h = self._lib.prefetch_open(
            inner.path.encode(), inner.header_bytes,
            block_samples * bps, stride_samples * bps, depth)
        if not self._h:
            raise OSError(f"prefetch_open failed for {inner.path}")
        self._expected = 0

    @property
    def total_samples(self) -> int:
        return self.inner.total_samples

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        if (nsamp == self.block_samples and start == self._expected
                and self._h):
            out = np.empty(nsamp * self._bps, np.uint8)
            off = ctypes.c_int64()
            got = self._lib.prefetch_next(
                self._h, out.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(off))
            if got > 0 and off.value == start * self._bps:
                self._expected += self.stride_samples
                return out
            # sequence broken (seek or eof): fall back
        return self.inner.read_samples(start, nsamp)

    def close(self):
        if self._h:
            self._lib.prefetch_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RingWriter:
    """Producer side of the live-capture SHM ring."""

    def __init__(self, name: str, obs: Observation, buf_bytes: int,
                 nbufs: int = 16, hdr_bytes: int = 4096):
        self._lib = load_hostio()
        self._h = self._lib.ring_create(name.encode(), hdr_bytes, buf_bytes,
                                        nbufs)
        if not self._h:
            raise OSError(f"ring_create({name}) failed")
        self.name = name
        self.buf_bytes = buf_bytes
        from .dada import header_from_observation

        hdr = format_ascii_header(header_from_observation(obs), hdr_bytes)
        self._lib.ring_write_header(self._h, hdr, len(hdr))

    def push(self, buf: np.ndarray) -> bool:
        assert buf.nbytes == self.buf_bytes
        b = np.ascontiguousarray(buf.view(np.uint8))
        return bool(self._lib.ring_push(
            self._h, b.ctypes.data_as(ctypes.c_void_p)))

    def set_eod(self):
        self._lib.ring_set_eod(self._h)

    def close(self, unlink: bool = True):
        if self._h:
            self._lib.ring_close(self._h, int(unlink))
            self._h = None


class RingReader(Source):
    """Consumer side: a Source over the live ring (DADABuffer equivalent).

    ``read_samples`` serves sequential *forward* reads of any size and
    stride — including the overlapping reads of the coherent-dedispersion
    block loop (stride < block).  Ring buffers are popped as needed and the
    trailing bytes are carried host-side between reads, exactly the role of
    the reference's overlap recycling in ``Seekable::load_data``
    (``Kernel/Classes/Seekable.C:197-222``) that lets ``DADABuffer`` feed
    full pipelines live.  Seeking backwards beyond the carried tail is not
    possible on a live stream.
    """

    def __init__(self, name: str):
        self._lib = load_hostio()
        self._h = self._lib.ring_connect(name.encode())
        if not self._h:
            raise OSError(f"ring_connect({name}) failed")
        hdr_bytes = self._lib.ring_hdr_bytes(self._h)
        buf = ctypes.create_string_buffer(hdr_bytes)
        if not self._lib.ring_read_header(self._h, buf, hdr_bytes):
            raise OSError("ring header not written yet")
        self.obs = observation_from_header(
            parse_ascii_header(buf.raw.decode("latin-1")))
        self.buf_bytes = self._lib.ring_buf_bytes(self._h)
        # carried bytes cover stream bytes [_carry_start, _carry_start+len)
        self._carry = np.empty(0, np.uint8)
        self._carry_start = 0

    @property
    def total_samples(self) -> int:
        return 1 << 62  # unbounded stream; ends via end-of-data

    def buffer_samples(self) -> int:
        return self.buf_bytes // int(self.obs.nbytes_per_sample)

    def _pop(self) -> np.ndarray:
        import time

        out = np.empty(self.buf_bytes, np.uint8)
        while True:
            r = self._lib.ring_pop(self._h, out.ctypes.data_as(ctypes.c_void_p))
            if r == 1:
                return out
            if r == -1:
                raise EOFError("ring end of data")
            time.sleep(0.0005)

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        a = start * bps
        b = (start + nsamp) * bps
        if a < self._carry_start:
            raise ValueError(
                f"live ring cannot seek back to byte {a} "
                f"(tail carried from {self._carry_start})")
        chunks = [self._carry]
        end = self._carry_start + self._carry.size
        while end < b:
            nxt = self._pop()
            chunks.append(nxt)
            end += nxt.size
        data = np.concatenate(chunks) if len(chunks) > 1 else self._carry
        off = a - self._carry_start
        out = data[off : off + (b - a)].copy()
        # keep everything from byte a onward: the next read may overlap
        self._carry = data[off:]
        self._carry_start = a
        return out

    def close(self, unlink: bool = False):
        if self._h:
            self._lib.ring_close(self._h, int(unlink))
            self._h = None


class DadaWriter:
    """Producer side of the psrdada-style SysV hdu (data block at ``key``,
    header block at ``key + 1``, semaphore flow control — the transport the
    reference's ``DADABuffer`` attaches to; see native/hostio.cpp for the
    layout and the cited psrdada conventions)."""

    def __init__(self, key: int, obs: Observation, buf_bytes: int,
                 nbufs: int = 16, hdr_bytes: int = 4096):
        self._lib = load_hostio()
        self._h = self._lib.dada_create(key, nbufs, buf_bytes, hdr_bytes)
        if not self._h:
            raise OSError(f"dada_create(0x{key:x}) failed")
        self.key = key
        self.buf_bytes = buf_bytes
        from .dada import header_from_observation

        hdr = format_ascii_header(header_from_observation(obs), hdr_bytes)
        self._lib.dada_write_header(self._h, hdr, len(hdr))

    def push(self, buf: np.ndarray, timeout: float = 10.0) -> bool:
        assert buf.nbytes == self.buf_bytes
        b = np.ascontiguousarray(buf.view(np.uint8))
        return bool(self._lib.dada_push(
            self._h, b.ctypes.data_as(ctypes.c_void_p), timeout))

    def set_eod(self):
        self._lib.dada_set_eod(self._h)

    def close(self, destroy: bool = True):
        if self._h:
            self._lib.dada_close(self._h, int(destroy))
            self._h = None


class DadaReader(RingReader):
    """Consumer side of the psrdada-style SysV hdu: a Source with the same
    overlap-carrying forward-read semantics as :class:`RingReader` (the
    ``DADABuffer`` role, ``Kernel/Formats/dada/dsp/DADABuffer.h:17-80``)."""

    def __init__(self, key: int = DADA_DEFAULT_BLOCK_KEY,
                 timeout: float = 10.0):
        self._lib = load_hostio()
        self._h = self._lib.dada_connect(key)
        if not self._h:
            raise OSError(f"dada_connect(0x{key:x}) failed")
        self.key = key
        self.timeout = timeout
        hdr_bytes = self._lib.dada_hdr_bufsz(self._h)
        buf = ctypes.create_string_buffer(hdr_bytes)
        if not self._lib.dada_read_header(self._h, buf, hdr_bytes):
            raise OSError("dada header not written yet")
        self.obs = observation_from_header(
            parse_ascii_header(buf.raw.decode("latin-1")))
        self.buf_bytes = self._lib.dada_bufsz(self._h)
        self._carry = np.empty(0, np.uint8)
        self._carry_start = 0

    def _pop(self) -> np.ndarray:
        out = np.empty(self.buf_bytes, np.uint8)
        r = self._lib.dada_pop(self._h, out.ctypes.data_as(ctypes.c_void_p),
                               self.timeout)
        if r == 1:
            return out
        if r == -1:
            raise EOFError("dada ring end of data")
        raise TimeoutError(f"dada ring empty after {self.timeout}s")

    def close(self, destroy: bool = False):
        if self._h:
            self._lib.dada_close(self._h, int(destroy))
            self._h = None
