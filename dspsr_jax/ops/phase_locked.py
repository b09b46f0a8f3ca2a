"""Phase-locked filterbank: phase-resolved spectra for very slow pulsars.

Equivalent of the reference ``dsp::PhaseLockedFilterbank``
(``Signal/Pulsar/PhaseLockedFilterbank.C:17-260``,
``dsp/PhaseLockedFilterbank.h``): instead of channelizing then folding
(which loses spectral resolution to the detection window), one short FFT of
``ndat_fft`` samples is taken at every pulse-phase-bin boundary predicted by
the ephemeris, and the detected spectrum accumulates into that phase bin —
yielding ``nbin`` phase-resolved spectra of ``nchan`` channels per input
channel.  The reference divides time with ``TimeDivide`` set to
``1/nbin`` turns (``PhaseLockedFilterbank.C:38-39``) and takes the first
``ndat_fft`` samples of each division (``:100-110`` sets ndat_fft = 2*nchan
for Nyquist input, nchan for Analytic; the spectrum for division with phase
bin ``b`` is accumulated and ``hits[b]++``, ``:233-237``).

Formulation: the phase-boundary walk (data-dependent, float64) runs on the
host against the predictor (`window_plan`), producing for each block a
dense batch of window start indices + phase-bin ids; the device does ONE
program per block — batched FFT over all windows, polarimetric detection,
and a one-hot contraction fold over the window axis.  Window extraction is
a host-side strided copy: this mode targets very slow pulsars where windows
are sparse in the stream, so the FFT + detect + fold dominate.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..timing.mjd import MJD
from . import sc
from .mxfft import fft_sc, rfft_sc, fftshift_sc

SC = sc.SC


@dataclass(frozen=True)
class PLFPlan:
    """Static geometry of the phase-locked filterbank.

    nchan: output channels per input channel (FFT length in complex bins).
    nbin: pulse-phase bins (the TimeDivide granularity, 1/nbin turns).
    npol_out: 1 (Intensity), 2 (PPQQ) or 4 (Coherence) — matches the
      reference's ``set_npol`` check (``PhaseLockedFilterbank.C:41-47``).
    real_input: Nyquist-sampled input (ndat_fft = 2*nchan,
      ``PhaseLockedFilterbank.C:100-104``) vs Analytic (ndat_fft = nchan).
    """

    nchan: int
    nbin: int
    npol_out: int = 1
    real_input: bool = True

    def __post_init__(self):
        if self.npol_out not in (1, 2, 4):
            raise ValueError(f"npol_out must be 1|2|4, got {self.npol_out}")
        if self.nchan < 2 or self.nbin < 2:
            raise ValueError("need nchan >= 2 and nbin >= 2")

    @property
    def ndat_fft(self) -> int:
        return 2 * self.nchan if self.real_input else self.nchan


def suggest_nchan(period: float, rate: float, nbin: int) -> int:
    """Reference heuristic (``PhaseLockedFilterbank.C:66-76``): the largest
    power of two <= samples available per phase bin."""
    samples_per_bin = period * rate / nbin
    if samples_per_bin < 2:
        raise ValueError("phase bin shorter than 2 samples")
    return 2 ** int(np.floor(np.log2(samples_per_bin)))


def window_plan(
    predictor,
    start_time: MJD,
    rate: float,
    ndat: int,
    plan: PLFPlan,
) -> Tuple[np.ndarray, np.ndarray]:
    """Walk the pulse-phase-bin boundaries across one block (host, float64).

    Mirrors the reference's TimeDivide loop with ``turns = 1/nbin``
    (``PhaseLockedFilterbank.C:209-240``): each division starts at the next
    multiple of 1/nbin turns; the window is its first ``ndat_fft`` samples;
    the division's phase bin indexes the accumulator.

    Returns (starts int64[nwin] sample offsets into the block,
    bins int32[nwin] phase-bin ids).  Windows that would overrun the block
    are dropped (the host block loop re-reads with overlap so no boundary is
    lost; see FoldPipeline._plan_blocks for the same pattern).
    """
    tsamp = 1.0 / rate
    nbin = plan.nbin
    starts, bins = [], []
    idat = 0
    while True:
        t = start_time + idat * tsamp
        frac = predictor.fracturns(t)
        # next boundary k/nbin at or after frac (within half-sample slop)
        f = predictor.frequency(t)
        slop = 0.5 * tsamp * f * nbin  # half a sample, in bin units
        k = np.ceil(frac * nbin - slop)
        delta_turns = k / nbin - frac
        if delta_turns < 0:
            delta_turns = 0.0
        # Newton refinement of the boundary time (phase is smooth; one
        # correction pass reaches << 1 sample for polyco spans)
        t_b = t + delta_turns / f
        for _ in range(2):
            frac_b = predictor.fracturns(t_b)
            err = frac_b * nbin - k
            err -= np.round(err / nbin) * nbin  # wrap to nearest turn
            t_b = t_b - (err / nbin) / predictor.frequency(t_b)
        off = int(np.ceil((t_b - start_time) * rate - 1e-9))
        if off < idat:
            off = idat
        if off + plan.ndat_fft > ndat:
            break
        starts.append(off)
        bins.append(int(k) % nbin)
        idat = off + 1  # advance past this boundary
        # jump close to the next boundary to keep the walk O(nwin)
        idat = max(idat, off + int(0.9 / (predictor.frequency(t_b) * nbin * tsamp)))
    return (np.asarray(starts, dtype=np.int64),
            np.asarray(bins, dtype=np.int32))


def extract_windows(x: np.ndarray, starts: np.ndarray, ndat_fft: int) -> np.ndarray:
    """Host-side window gather: x[..., ndat] -> [nwin, ..., ndat_fft]."""
    return np.stack([x[..., s:s + ndat_fft] for s in starts], axis=0)


def _detect_windows(spec: SC, npol_in: int, npol_out: int) -> jnp.ndarray:
    """[nwin, nchan_in, npol_in, nchan] split-complex spectra ->
    [nwin, nchan_in, npol_out, nchan] detected planes."""
    re, im = spec
    pp = re[:, :, 0] ** 2 + im[:, :, 0] ** 2
    if npol_in == 1:
        if npol_out != 1:
            raise ValueError("npol_out > 1 needs 2 input polarizations")
        return pp[:, :, None]
    qq = re[:, :, 1] ** 2 + im[:, :, 1] ** 2
    if npol_out == 1:
        return (pp + qq)[:, :, None]
    if npol_out == 2:
        return jnp.stack([pp, qq], axis=2)
    # Coherence: PP, QQ, Re(P conj(Q)), Im(P conj(Q))
    repq = re[:, :, 0] * re[:, :, 1] + im[:, :, 0] * im[:, :, 1]
    impq = im[:, :, 0] * re[:, :, 1] - re[:, :, 0] * im[:, :, 1]
    return jnp.stack([pp, qq, repq, impq], axis=2)


@partial(jax.jit, static_argnames=("plan",), donate_argnames=("spectra", "hits"))
def plf_fold_block(
    spectra: jnp.ndarray,
    hits: jnp.ndarray,
    windows,
    bins: jnp.ndarray,
    plan: PLFPlan,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate one block of phase-locked windows.

    Args:
      spectra: float32[nchan_out, npol_out, nbin] accumulator (donated),
        nchan_out = nchan_in * plan.nchan (input channel major).
      hits: float32[nbin] (donated) — one global hit count per bin, as the
        reference keeps (``PhaseLockedFilterbank.C:233``).
      windows: real float32[nwin, nchan_in, npol_in, ndat_fft] when
        plan.real_input, else split-complex pair of
        float32[nwin, nchan_in, npol_in, nchan].
      bins: int32[nwin] phase-bin ids from `window_plan`.

    Returns updated (spectra, hits).
    """
    if plan.real_input:
        nwin, nchan_in, npol_in = windows.shape[:3]
        spec = rfft_sc(windows, plan.ndat_fft)  # natural ascending offsets
    else:
        nwin, nchan_in, npol_in = windows[0].shape[:3]
        spec = fft_sc(windows, plan.nchan)
        spec = fftshift_sc(spec)  # natural order (reference band-swaps and
        # records nsub_swap; we emit natural order like ops/filterbank)
    det = _detect_windows(spec, npol_in, plan.npol_out)
    # det: [nwin, nchan_in, npol_out, nchan] -> [nwin, nchan_out*npol_out]
    det = jnp.moveaxis(det, 3, 2)  # [nwin, nchan_in, nchan, npol_out]
    flat = det.reshape(nwin, nchan_in * plan.nchan * plan.npol_out)
    # one-hot fold over the window axis (gather-free)
    bin_ids = jax.lax.broadcasted_iota(jnp.int32, (nwin, plan.nbin), 1)
    onehot = (bins[:, None] == bin_ids).astype(jnp.float32)
    acc = jnp.matmul(flat.T, onehot, precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    spectra = spectra + acc.reshape(nchan_in * plan.nchan, plan.npol_out,
                                    plan.nbin)
    hits = hits + jnp.sum(onehot, axis=0)
    return spectra, hits


def plf_fold_numpy(spectra, hits, windows, bins, plan: PLFPlan):
    """Numpy mirror of `plf_fold_block` using numpy FFTs, for testing."""
    spectra = spectra.copy()
    hits = hits.copy()
    if plan.real_input:
        spec = np.fft.rfft(windows, axis=-1)[..., : plan.nchan]
    else:
        w = windows[0] + 1j * windows[1]
        spec = np.fft.fftshift(np.fft.fft(w, axis=-1), axes=-1)
    npol_in = spec.shape[2]
    pp = np.abs(spec[:, :, 0]) ** 2
    if plan.npol_out == 1:
        det = pp[:, :, None] if npol_in == 1 else (pp + np.abs(spec[:, :, 1]) ** 2)[:, :, None]
    elif plan.npol_out == 2:
        det = np.stack([pp, np.abs(spec[:, :, 1]) ** 2], axis=2)
    else:
        pq = spec[:, :, 0] * np.conj(spec[:, :, 1])
        det = np.stack([pp, np.abs(spec[:, :, 1]) ** 2, pq.real, pq.imag], axis=2)
    det = np.moveaxis(det, 3, 2)  # [nwin, nchan_in, nchan, npol_out]
    nwin = det.shape[0]
    flat = det.reshape(nwin, -1, plan.npol_out)
    for w_i in range(nwin):
        spectra[:, :, bins[w_i]] += flat[w_i]
        hits[bins[w_i]] += 1
    return spectra, hits


@dataclass
class PLFResult:
    """Phase-resolved spectra: [nchan_out, npol_out, nbin] + hits[nbin]."""

    spectra: np.ndarray
    hits: np.ndarray
    plan: PLFPlan

    def normalized(self) -> np.ndarray:
        h = np.maximum(self.hits, 1.0)
        return self.spectra / h[None, None, :]


def phase_locked_fold(
    source,
    predictor,
    plan: Optional[PLFPlan] = None,
    *,
    nchan: int = 0,
    nbin: int = 16,
    npol_out: int = 1,
    block_samples: int = 1 << 20,
    max_blocks: Optional[int] = None,
) -> PLFResult:
    """End-to-end phase-locked filterbank over a Source.

    Host loop: read + unpack a block, plan windows against the predictor,
    extract them, run one device program.  Blocks overlap by ndat_fft-1 so
    no boundary window is lost (mirrors InputBuffering's tail carry).
    """
    from ..unpack.unpackers import UnpackPlan
    from ..observation import Signal

    obs = source.obs
    real_input = obs.state == Signal.NYQUIST
    if plan is None:
        if not nchan:
            period = 1.0 / predictor.frequency(obs.start_time)
            nchan = suggest_nchan(period, obs.rate, nbin)
        plan = PLFPlan(nchan=nchan, nbin=nbin, npol_out=npol_out,
                       real_input=real_input)
    unpack = UnpackPlan(obs)

    nchan_out = obs.nchan * plan.nchan
    spectra = jnp.zeros((nchan_out, plan.npol_out, plan.nbin), jnp.float32)
    hits = jnp.zeros((plan.nbin,), jnp.float32)

    total = source.total_samples
    stride = block_samples - plan.ndat_fft  # overlap = ndat_fft
    start = 0
    iblock = 0
    while start + plan.ndat_fft <= total:
        if max_blocks is not None and iblock >= max_blocks:
            break
        n = min(block_samples, total - start)
        raw = source.read_samples(start, n)
        x, _w = unpack.unpack(jnp.asarray(raw))
        t0 = obs.start_time + start / obs.rate
        starts, bins = window_plan(predictor, t0, obs.rate, n, plan)
        if start + block_samples < total:
            # windows at offset >= stride belong to the next (overlapping)
            # block — keep each boundary exactly once
            keep = starts < stride
            starts, bins = starts[keep], bins[keep]
        if len(starts):
            if real_input:
                windows = jnp.asarray(
                    extract_windows(np.asarray(x), starts, plan.ndat_fft))
            else:
                xr, xi = x
                windows = (jnp.asarray(extract_windows(np.asarray(xr), starts, plan.nchan)),
                           jnp.asarray(extract_windows(np.asarray(xi), starts, plan.nchan)))
            spectra, hits = plf_fold_block(spectra, hits, windows,
                                           jnp.asarray(bins), plan)
        start += stride
        iblock += 1
    return PLFResult(np.asarray(spectra), np.asarray(hits), plan)
