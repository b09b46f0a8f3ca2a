"""Pulse-phase folding on device.

Equivalent of the reference ``dsp::Fold`` (``Signal/Pulsar/Fold.C``): every
time sample is assigned a pulse-phase bin ``ibin = floor(frac(phi)*nbin)``
(``Fold.C:766-770``) where the phase advances linearly by
``phase_per_sample = tsamp/pfold`` from a predictor-evaluated start phase
(``Fold.C:744-788``, ``get_phi`` at ``Fold.C:943-950``); samples accumulate
into per-(chan,pol) phase-bin profiles plus a hit counter per bin
(``Fold.C:835-873``).

Formulation: the data-dependent scatter-add becomes a **one-hot
contraction** — build ``onehot[T, nbin]`` from the bin indices and contract
``profiles += data[cp, T] @ onehot`` over the block, at float32 precision.
(The reference's CUDA engine compresses the binplan into intervals,
``FoldCUDA.cu:84-112``; timing this contraction against a segment sum on
the GPU is open work.)

Phase precision: f32 on device would lose the pulse phase over a long block,
so the host supplies float64-derived **per-segment anchors**: the fractional
phase at the start of every ``seg_len``-sample segment (evaluated from the
polyco in float64, see ``timing.polyco.Polyco.phase_anchors``).  Within a
segment the device adds ``arange(seg_len)*dphi`` in float32 — anchor spacing
is chosen so the accumulated f32 error stays ≪ one bin.  This also tracks
polynomial phase curvature better than the reference's per-block linear
advance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..timing.mjd import MJD


@dataclass(frozen=True)
class FoldPlan:
    """Static fold geometry."""

    nbin: int
    seg_len: int  # samples per phase-anchor segment (power of two)

    def nseg(self, ndat: int) -> int:
        if ndat % self.seg_len:
            raise ValueError(f"ndat={ndat} not a multiple of seg_len={self.seg_len}")
        return ndat // self.seg_len


def choose_nbin(period: float, tsamp: float, requested: int = 0,
                maximum: int = 1024) -> int:
    """Reference ``Fold::choose_nbin`` heuristic (``Fold.C:275-382``):
    largest power of two <= period/(1.2*tsamp), capped at ``maximum``
    (default 1024), unless explicitly requested."""
    if requested:
        return requested
    limit = period / (1.2 * tsamp)
    nbin = 1
    while nbin * 2 <= limit and nbin * 2 <= maximum:
        nbin *= 2
    return max(nbin, 2)


def compute_anchors(
    predictor,
    start_time: MJD,
    tsamp: float,
    ndat: int,
    seg_len: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side float64 phase anchors for one block.

    Returns (phi0[nseg] float32 fractional turns at segment starts,
    dphi[nseg] float32 phase-per-sample within each segment).

    dphi is evaluated per segment from the predictor frequency (the
    reference evaluates ``pfold`` once per block, ``Fold.C:723``; per-segment
    is strictly more accurate).
    """
    nseg = ndat // seg_len
    offsets = np.arange(nseg, dtype=np.int64) * seg_len
    phi0 = predictor.phase_anchors(start_time, tsamp, offsets)
    dphi = np.empty(nseg, dtype=np.float64)
    for i, off in enumerate(offsets):
        t = start_time + float(off) * tsamp
        dphi[i] = tsamp * predictor.frequency(t)
    return phi0.astype(np.float32), dphi.astype(np.float32)


@partial(jax.jit, static_argnames=("seg_len", "nbin"))
def compute_bins(phi0: jnp.ndarray, dphi: jnp.ndarray, seg_len: int,
                 *, nbin: int) -> jnp.ndarray:
    """Per-sample phase-bin indices from segment anchors.

    phi0, dphi: float32[nseg].  Returns int32[nseg*seg_len].
    """
    nseg = phi0.shape[0]
    i = jnp.arange(seg_len, dtype=jnp.float32)
    phase = phi0[:, None] + dphi[:, None] * i[None, :]
    frac = phase - jnp.floor(phase)
    bins = jnp.floor(frac * nbin).astype(jnp.int32)
    return jnp.clip(bins, 0, nbin - 1).reshape(nseg * seg_len)


@partial(jax.jit, static_argnames=("plan",), donate_argnames=("profiles", "hits"))
def fold_block(
    profiles: jnp.ndarray,
    hits: jnp.ndarray,
    x: jnp.ndarray,
    weights: jnp.ndarray,
    phi0: jnp.ndarray,
    dphi: jnp.ndarray,
    plan: FoldPlan,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fold one block into carried accumulators.

    Args:
      profiles: float32[nchan, npol, nbin] accumulator (donated).
      hits: float32[nchan, nbin] per-channel hit counts (donated).
        (The reference keeps one global hits array unless zeroed_samples;
        per-channel is a superset — sum over chan 0 to compare.)
      x: float32[nchan, npol, ndat] detected data (for complex folding pass
        the real/imag planes as extra pols).
      weights: float32[nchan, ndat]; 0 masks a sample (reference binplan set
        to the trash bin for bad weights, ``Fold.C:782-788``).
      phi0, dphi: float32[nseg] segment phase anchors.
      plan: static geometry.

    Returns updated (profiles, hits).
    """
    nchan, npol, ndat = x.shape
    nbin, seg_len = plan.nbin, plan.seg_len
    nseg = ndat // seg_len

    # per-sample phase from segment anchors, all segments at once
    i = jnp.arange(seg_len, dtype=jnp.float32)
    phase = phi0[:, None] + dphi[:, None] * i[None, :]  # [nseg, seg_len]
    frac = phase - jnp.floor(phase)
    bins = jnp.clip(jnp.floor(frac * nbin).astype(jnp.int32), 0, nbin - 1)
    bins = bins.reshape(nseg * seg_len)

    # one-hot contraction over the whole block; HIGHEST keeps the float32
    # products out of TF32 (which would round the data to 10 mantissa bits)
    bin_ids = jax.lax.broadcasted_iota(jnp.int32, (nseg * seg_len, nbin), 1)
    onehot = (bins[:, None] == bin_ids).astype(jnp.float32)

    xw = (x * weights[:, None, :]).reshape(nchan * npol, ndat)
    profiles = profiles + jnp.matmul(
        xw[:, : nseg * seg_len], onehot,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).reshape(nchan, npol, nbin)
    hits = hits + jnp.matmul(
        weights[:, : nseg * seg_len], onehot,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return profiles, hits


def fold_block_numpy(
    profiles: np.ndarray,
    hits: np.ndarray,
    x: np.ndarray,
    weights: np.ndarray,
    phi0: np.ndarray,
    dphi: np.ndarray,
    plan: FoldPlan,
) -> Tuple[np.ndarray, np.ndarray]:
    """Straight-line numpy reference implementation (mirrors the reference
    C++ inner loop, ``Fold.C:744-788`` + ``:835-873``) for testing."""
    nchan, npol, ndat = x.shape
    nseg = ndat // plan.seg_len
    profiles = profiles.copy()
    hits = hits.copy()
    for s in range(nseg):
        for k in range(plan.seg_len):
            phi = float(phi0[s]) + float(dphi[s]) * k
            frac = phi - math.floor(phi)
            ibin = min(int(frac * plan.nbin), plan.nbin - 1)
            t = s * plan.seg_len + k
            for c in range(nchan):
                w = weights[c, t]
                hits[c, ibin] += w
                for p in range(npol):
                    profiles[c, p, ibin] += x[c, p, t] * w
    return profiles, hits
