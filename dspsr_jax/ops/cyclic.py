"""Cyclic spectroscopy: folding lag products by pulse phase.

Equivalent of the reference ``dsp::CyclicFold`` + ``CyclicFoldEngine``
(``Signal/Pulsar/CyclicFold.C``, ``dsp/CyclicFold.h:21-140``; method of
Demorest 2011, MNRAS 416, 2821): instead of folding detected power, fold the
complex *lag products*::

    c_l[t] = x[t] * conj(x[t - l])      l = 0 .. nlag-1

by pulse phase into (nbin, nlag) accumulators; the Fourier transform over
lag at unload time yields the phase-resolved **cyclic spectrum** — channel
profiles with intra-channel frequency structure resolved beyond the
filterbank resolution (the periodic spectrum of the scintillated pulsar).

The reference uses nlag = mover*nchan/2 + 1 lags for nchan output channels
with oversampling factor mover (``CyclicFold.h``); transforming the folded
(Hermitian) lag sequence gives nchan_cyclic = 2*(nlag-1)/mover channels.

Formulation: the lag products for all lags are built with nlag shifted
elementwise multiplies (static slices), then the existing fold contraction
(ops.fold, float32 precision) accumulates all 2*nlag real planes at once —
the lag axis rides the fold's "pol" axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import sc

SC = sc.SC


@dataclass(frozen=True)
class CyclicPlan:
    """Static cyclic-fold geometry (reference ``CyclicFold::set_nlag``)."""

    nchan_cyclic: int  # output cyclic channels per input channel
    mover: int = 1  # oversampling factor (channel isolation)

    @property
    def nlag(self) -> int:
        return self.mover * self.nchan_cyclic // 2 + 1


@partial(jax.jit, static_argnames=("nlag",))
def lag_products(x: SC, nlag: int) -> SC:
    """Complex lag products of analytic voltages.

    x: split-complex [nchan, npol, ndat].
    Returns split-complex [nchan, npol, nlag, ndat - nlag + 1]:
    ``out[..., l, t] = x[..., t + l] * conj(x[..., t])`` (lags reference the
    *later* sample so all lags share the valid range).
    """
    xr, xi = x
    nkeep = xr.shape[-1] - nlag + 1
    base_r = xr[..., :nkeep]
    base_i = xi[..., :nkeep]
    outs_r, outs_i = [], []
    for l in range(nlag):
        sr = jax.lax.slice_in_dim(xr, l, l + nkeep, axis=-1)
        si = jax.lax.slice_in_dim(xi, l, l + nkeep, axis=-1)
        # x[t+l] * conj(x[t])
        outs_r.append(sr * base_r + si * base_i)
        outs_i.append(si * base_r - sr * base_i)
    return (jnp.stack(outs_r, axis=-2), jnp.stack(outs_i, axis=-2))


def lag_planes(x: SC, nlag: int) -> jnp.ndarray:
    """Lag products flattened into fold 'pol' planes.

    [nchan, npol, ndat] -> [nchan, npol*nlag*2, ndat-nlag+1] float32 with
    plane index p = ((ipol*nlag + l)*2 + is_imag).
    """
    cr, ci = lag_products(x, nlag)
    nchan, npol, _, nkeep = cr.shape
    stacked = jnp.stack([cr, ci], axis=3)  # [nchan, npol, nlag, 2, nkeep]
    return stacked.reshape(nchan, npol * nlag * 2, nkeep)


def cyclic_spectra(folded_planes: np.ndarray, nlag: int, mover: int,
                   npol: int = 1) -> np.ndarray:
    """Transform folded lag planes into phase-resolved cyclic spectra.

    folded_planes: float64[nchan, npol*nlag*2, nbin] (hit-normalized fold
    output).  Returns float64[nchan, npol, nbin, nchan_cyclic] real cyclic
    periodic spectra, nchan_cyclic = 2*(nlag-1)//mover.

    The folded lag function is Hermitian in lag (c[-l] = conj(c[l])), so a
    real FFT over the one-sided lag sequence gives the real periodic
    spectrum (reference ``CyclicFoldEngine::synch``).
    """
    nchan = folded_planes.shape[0]
    nbin = folded_planes.shape[-1]
    planes = folded_planes.reshape(nchan, npol, nlag, 2, nbin)
    c = planes[:, :, :, 0] + 1j * planes[:, :, :, 1]  # [nchan, npol, nlag, nbin]
    c = np.moveaxis(c, 2, 3)  # [nchan, npol, nbin, nlag]
    # Hermitian extension: full lag axis length 2*(nlag-1)
    nfull = 2 * (nlag - 1)
    full = np.zeros((*c.shape[:-1], nfull), np.complex128)
    full[..., :nlag] = c
    full[..., nlag:] = np.conj(c[..., -2:0:-1])
    spec = np.fft.fftshift(np.fft.fft(full, axis=-1), axes=-1).real
    if mover > 1:
        # decimate the oversampled spectrum back to nchan_cyclic channels
        spec = spec.reshape(*spec.shape[:-1], nfull // mover, mover).mean(-1)
    return spec
