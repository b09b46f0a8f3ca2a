"""Device-side n-bit unpacking kernels (gather-free).

Equivalent of the reference Unpacker hierarchy
(``Kernel/Classes/dsp/Unpacker.h``, ``BitUnpacker.C``, ``EightBitUnpacker.C``,
``FloatUnpacker.C``, ``TwoBitCorrection.C``): convert packed telescope bytes
into float32 voltages on device.  Where the reference unpacks on the CPU with
per-byte lookup tables (or ``GenericEightBitUnpackerCUDA.cu`` on GPU), here
the byte stream is shipped to the device raw (4x fewer host-to-device bytes
than float32 for 8-bit data) and expanded inside the same jit program as the
DSP chain.

Lookups are expressed as:
- **arithmetic** for the uniform level tables (value = (code - mid) * step —
  exactly what BitTable's uniform levels reduce to), and
- **table gathers** for genuinely tabular lookups (JA98 dynamic levels
  indexed by per-block nlow counts).

Layout: input is the raw byte stream of one block in **TFP order** (the DADA
convention: time-major, then chan, pol, dim — ``ASCIIObservation.C``); output
is FPT ``[nchan, npol, ndat]`` float32, as a split-complex (re, im) pair when
ndim == 2, matching the reference's ``TimeSeries::OrderFPT``
(``TimeSeries.h:29-37``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..observation import Observation, Signal
from .bittable import BitTable, CodeType, optimal_spacing
from .twobit import TwoBitCorrection


@partial(jax.jit, static_argnames=("nbit", "msb_first"))
def bytes_to_codes(raw: jnp.ndarray, nbit: int, msb_first: bool = True) -> jnp.ndarray:
    """Expand packed bytes into per-sample integer codes.

    raw: uint8[nbytes] -> int32[nbytes * 8/nbit].
    msb_first: extract the most significant field first (reference
    ``BitTable::extract`` order MostToLeast, ``BitTable.C:152-163``).
    """
    if nbit == 8:
        return raw.astype(jnp.int32)
    per = 8 // nbit
    mask = (1 << nbit) - 1
    shifts = np.arange(per) * nbit
    if msb_first:
        shifts = shifts[::-1]
    shifts = jnp.asarray(shifts.copy(), dtype=jnp.int32)
    codes = (raw[:, None].astype(jnp.int32) >> shifts[None, :]) & mask
    return codes.reshape(-1)


@partial(jax.jit, static_argnames=("nchan", "npol", "ndim"))
def tfp_to_fpt(samples: jnp.ndarray, nchan: int, npol: int, ndim: int):
    """Reorder flat TFP samples to FPT [nchan, npol, ndat]; split-complex
    (re, im) pair when ndim == 2.

    samples: float32[ndat*nchan*npol*ndim] in (t, chan, pol, dim) order.
    """
    ndat = samples.shape[0] // (nchan * npol * ndim)
    x = samples.reshape(ndat, nchan, npol, ndim)
    x = jnp.transpose(x, (1, 2, 0, 3))  # [nchan, npol, ndat, ndim]
    if ndim == 2:
        return x[..., 0], x[..., 1]
    return x[..., 0]


def _uniform_levels(codes: jnp.ndarray, nbit: int, twos_complement: bool) -> jnp.ndarray:
    """Arithmetic form of the BitTable uniform level map
    (``BitTable.C:165-218``): ascending level index -> (idx - mid) * step,
    variance-normalized; twos-complement codes wrap the index."""
    n = 1 << nbit
    table = BitTable(nbit, CodeType.TWOS_COMPLEMENT if twos_complement
                     else CodeType.OFFSET_BINARY)
    asc = np.sort(table.values.astype(np.float64))
    # full-range estimate keeps the f32 step error from amplifying by n
    step = float((asc[-1] - asc[0]) / (n - 1)) if n > 1 else 2.0
    lo = float(asc[0])
    idx = codes
    if twos_complement:
        idx = jnp.where(codes >= n // 2, codes - n // 2, codes + n // 2)
    return idx.astype(jnp.float32) * step + lo


@partial(jax.jit, static_argnames=("nbit", "nchan", "npol", "ndim",
                                   "msb_first", "twos_complement"))
def unpack_fixed(
    raw: jnp.ndarray,
    nbit: int,
    nchan: int,
    npol: int,
    ndim: int,
    msb_first: bool = True,
    twos_complement: bool = False,
):
    """Fixed-level unpack (reference ``BitUnpacker::unpack``).

    raw: uint8[nbytes].  Returns FPT float32 (or split-complex pair).
    """
    codes = bytes_to_codes(raw, nbit, msb_first)
    vals = _uniform_levels(codes, nbit, twos_complement)
    return tfp_to_fpt(vals, nchan, npol, ndim)


@partial(jax.jit, static_argnames=("nchan", "npol", "ndim"))
def unpack_float32(raw: jnp.ndarray, nchan: int = 1, npol: int = 1, ndim: int = 1):
    """FloatUnpacker equivalent (re-ingest of dumped float TimeSeries)."""
    vals = jax.lax.bitcast_convert_type(raw.reshape(-1, 4), jnp.float32).reshape(-1)
    return tfp_to_fpt(vals, nchan, npol, ndim)


def _repeat_last(a: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Repeat each element of the last axis ``factor`` times
    (broadcast+reshape; no gather)."""
    expanded = jnp.broadcast_to(a[..., None], (*a.shape, factor))
    return expanded.reshape(*a.shape[:-1], a.shape[-1] * factor)


@partial(
    jax.jit,
    static_argnames=("nchan", "npol", "ndim", "ndat_per_weight", "msb_first"),
)
def unpack_twobit_dynamic(
    raw: jnp.ndarray,
    lo_table: jnp.ndarray,
    hi_table: jnp.ndarray,
    weight_table: jnp.ndarray,
    nchan: int,
    npol: int,
    ndim: int,
    ndat_per_weight: int,
    msb_first: bool = True,
):
    """Jenet-Anderson dynamic-level 2-bit unpack with excision weights.

    Equivalent of ``TwoBitCorrection::dig_unpack`` + ``ExcisionUnpacker``
    (``Kernel/Classes/TwoBitCorrection.C``, ``excision_unpack.h``): per
    digitizer stream (chan,pol,dim) and per block of ``ndat_per_weight``
    samples, count the low-voltage states, look up the JA98 output levels for
    that count, and flag blocks with anomalous counts.

    Codes (offset binary, 2-bit): 0,3 = outer (hi) negative/positive;
    1,2 = inner (lo) negative/positive (reference ``TwoBitTable``).

    Returns (x_fpt, weights[nchan, nweights]); weights apply to
    ``ndat_per_weight``-sample stretches of every pol of that channel
    (reference WeightedTimeSeries semantics).
    """
    codes = bytes_to_codes(raw, 2, msb_first)
    ndig = nchan * npol * ndim
    ndat = codes.shape[0] // ndig
    c = codes.reshape(ndat, ndig).T  # [ndig, ndat]

    sign = jnp.where(c >= 2, 1.0, -1.0).astype(jnp.float32)
    is_low = jnp.logical_or(c == 1, c == 2)

    nweights = ndat // ndat_per_weight
    cb = is_low[:, : nweights * ndat_per_weight].reshape(ndig, nweights, ndat_per_weight)
    nlow = jnp.sum(cb, axis=-1).astype(jnp.int32)  # [ndig, nweights]

    lo = jnp.take(lo_table, nlow)
    hi = jnp.take(hi_table, nlow)
    w_dig = jnp.take(weight_table, nlow)

    mag_lo = _repeat_last(lo, ndat_per_weight)
    mag_hi = _repeat_last(hi, ndat_per_weight)
    islow_f = is_low[:, : nweights * ndat_per_weight]
    vals = sign[:, : nweights * ndat_per_weight] * jnp.where(islow_f, mag_lo, mag_hi)

    # [ndig, T] -> FPT
    x = vals.reshape(nchan, npol, ndim, nweights * ndat_per_weight)
    if ndim == 2:
        xc = (x[:, :, 0, :], x[:, :, 1, :])
    else:
        xc = x[:, :, 0, :]

    # a block is bad if any digitizer of the channel is bad (min == AND)
    w = jnp.min(w_dig.reshape(nchan, npol * ndim, nweights), axis=1)
    return xc, w


@partial(jax.jit, static_argnames=("nbit", "hist_size"))
def digitizer_histogram(raw: jnp.ndarray, nbit: int, hist_size: int = 0) -> jnp.ndarray:
    """Histogram of sample codes (reference ``HistUnpacker``)."""
    codes = bytes_to_codes(raw, nbit)
    n = hist_size or (1 << nbit)
    onehot = (codes[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, n), 1)).astype(jnp.int32)
    return jnp.sum(onehot, axis=0)


def state_counts_from_byte_counts(byte_counts, nbit: int):
    """[256] byte-value histogram -> [1<<nbit] digitizer state histogram.

    Host-side companion of :func:`digitizer_histogram` for stats that ride
    the block loop without touching the device step (the role of the
    reference ``HistUnpacker`` counts that Archiver turns into the
    TwoBitStats/DigitiserCounts archive extensions).  State totals are
    independent of field order within the byte.
    """
    import numpy as _np

    byte_counts = _np.asarray(byte_counts, _np.int64)
    nstates = 1 << nbit
    if nbit == 8:
        return byte_counts.copy()
    per = 8 // nbit
    mask = nstates - 1
    b = _np.arange(256)
    out = _np.zeros(nstates, _np.int64)
    for k in range(per):
        _np.add.at(out, (b >> (k * nbit)) & mask, byte_counts)
    return out


#: Instrument-specific unpack options (the role of the reference Unpacker
#: registry, ``Kernel/Formats/Unpacker_registry.C``: ``matches()`` keys on
#: ``Observation::get_machine``).  Maps INSTRUMENT/machine name ->
#: UnpackPlan overrides.
INSTRUMENT_UNPACK = {
    # CASPSR: 8-bit two's complement, FOUR consecutive samples per pol
    # interleaved ([p0 t0..t3][p1 t0..t3] ...) — the reference benchmark's
    # own instrument (CASPSRSingleUnpacker.C:103-151, Benchmark/header.dada)
    "CASPSR": dict(layout="caspsr", twos_complement=True),
    # Mark5B: fixed-level (BitTable) 2-bit — no JA98 dynamic correction or
    # excision (the reference decodes via mark5access static level tables)
    "MARK5B": dict(dynamic_twobit=False),
}


@partial(jax.jit, static_argnames=("layout", "npol"))
def reorder_bytes_tfp(raw: jnp.ndarray, layout: str, npol: int) -> jnp.ndarray:
    """Reorder an instrument's raw 8-bit byte stream into TFP sample order
    (pure reshape/transpose — fuses into the consuming program)."""
    if layout == "tfp":
        return raw
    if layout == "caspsr":
        # [tblk, pol, 4] -> [tblk, 4, pol] (CASPSRSingleUnpacker.C:119-151)
        return jnp.transpose(raw.reshape(-1, npol, 4), (0, 2, 1)).reshape(-1)
    raise ValueError(f"unknown byte layout: {layout}")


@dataclass
class UnpackPlan:
    """Host-side description of how to unpack a stream; builds the tables."""

    obs: Observation
    twos_complement: bool = False
    dynamic_twobit: bool = True
    ndat_per_weight: int = 512
    cutoff_sigma: float = 3.0
    #: byte layout: "tfp" (DADA convention) or an instrument key from
    #: INSTRUMENT_UNPACK (auto-detected from obs.instrument)
    layout: str = "tfp"

    def __post_init__(self):
        inst = (self.obs.instrument or "").upper()
        opts = INSTRUMENT_UNPACK.get(inst)
        if opts is not None:
            self.layout = opts.get("layout", self.layout)
            self.twos_complement = opts.get("twos_complement",
                                            self.twos_complement)
            self.dynamic_twobit = opts.get("dynamic_twobit",
                                           self.dynamic_twobit)
        nbit = self.obs.nbit
        if nbit not in (1, 2, 4, 8, 32):
            raise ValueError(f"unsupported NBIT={nbit}")
        if self.layout == "caspsr" and (
                nbit != 8 or self.obs.nchan != 1 or self.obs.ndim != 1):
            raise ValueError("CASPSR layout is 8-bit real single-channel")
        if nbit == 2 and self.dynamic_twobit:
            self.twobit = TwoBitCorrection(self.ndat_per_weight, self.cutoff_sigma)
        else:
            self.twobit = None

    def bytes_per_sample(self) -> float:
        return self.obs.nbytes_per_sample

    def unpack(self, raw: jnp.ndarray):
        """Returns (x_fpt [real or split-complex], weights or None)."""
        o = self.obs
        if o.nbit == 32:
            return unpack_float32(raw, o.nchan, o.npol, o.ndim), None
        if self.layout != "tfp":
            raw = reorder_bytes_tfp(raw, self.layout, o.npol)
        if self.twobit is not None:
            return unpack_twobit_dynamic(
                raw,
                jnp.asarray(self.twobit.level_tables[0]),
                jnp.asarray(self.twobit.level_tables[1]),
                jnp.asarray(self.twobit.weight_table),
                o.nchan,
                o.npol,
                o.ndim,
                self.ndat_per_weight,
            )
        x = unpack_fixed(raw, o.nbit, o.nchan, o.npol, o.ndim,
                         twos_complement=self.twos_complement)
        return x, None
