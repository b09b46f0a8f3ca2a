"""Lag-domain spectrometry: autocorrelation spectra and the ACF filterbank.

Equivalents of the reference ``dsp::AutoCorrelation`` and ``dsp::ACFilterbank``
(``Signal/General/AutoCorrelation.C``, ``ACFilterbank.C``): estimate spectra
from time-averaged lag products instead of windowed FFTs — the classic
lag ("XF") spectrometer, useful where channel shapes must be controlled in
the lag domain.

Built on ops.cyclic.lag_products (the same shifted-multiply primitive the
cyclic fold uses); the lag->frequency transform is an FFT (ops.mxfft).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import sc
from .cyclic import lag_products
from .mxfft import fft_sc, ifft_sc

SC = sc.SC


@partial(jax.jit, static_argnames=("nlag",))
def autocorrelation(x: SC, nlag: int) -> SC:
    """Time-averaged complex autocorrelation function.

    x: split-complex [nchan, npol, ndat].
    Returns split-complex [nchan, npol, nlag]: <x[t+l] conj(x[t])>_t.
    """
    cr, ci = lag_products(x, nlag)
    return jnp.mean(cr, axis=-1), jnp.mean(ci, axis=-1)


def acf_spectra(acf: SC) -> np.ndarray:
    """Power spectra from the one-sided ACF via Hermitian extension
    (host-side; [*, nlag] -> real[*, 2*(nlag-1)], natural channel order)."""
    r = np.asarray(acf[0], dtype=np.float64)
    i = np.asarray(acf[1], dtype=np.float64)
    c = r + 1j * i
    nlag = c.shape[-1]
    nfull = 2 * (nlag - 1)
    full = np.zeros((*c.shape[:-1], nfull), np.complex128)
    full[..., :nlag] = c
    full[..., nlag:] = np.conj(c[..., -2:0:-1])
    return np.fft.fftshift(np.fft.fft(full, axis=-1), axes=-1).real


@partial(jax.jit, static_argnames=("nlag", "nblock"))
def acf_filterbank(x: SC, nlag: int, nblock: int) -> SC:
    """ACFilterbank: time-resolved ACFs over ``nblock`` equal sub-spans.

    Returns split-complex [nchan, npol, nblock, nlag].
    """
    cr, ci = lag_products(x, nlag)
    T = cr.shape[-1]
    span = T // nblock

    def blocks(a):
        a = a[..., : nblock * span]
        shape = (*a.shape[:-1], nblock, span)
        return jnp.mean(a.reshape(shape), axis=-1)

    return blocks(cr), blocks(ci)


@partial(jax.jit, static_argnames=("nchan", "nlag", "form_acf"))
def ac_filterbank(x: SC, nchan: int, nlag: int = 0,
                  form_acf: bool = False, window: jnp.ndarray | None = None) -> SC:
    """Zero-padded lag-domain filterbank (reference ``dsp::ACFilterbank``,
    ``Signal/General/ACFilterbank.C:40-293``).

    Frames each channel/pol into windows of ``ngood = nchan - nlag`` samples,
    zero-pads to ``nchan``, FFTs, and forms X * conj(X):

    - ``form_acf=False`` (mode 1): the power spectral density per window —
      split-complex [nchan_in, npol, nwin, nchan] with zero imaginary part
      (kept complex for parity with the reference layout, which stores the
      analytic PSD).
    - ``form_acf=True`` (mode 2): inverse FFT of the PSD — the non-cyclic
      autocorrelation function; returns the first ``nlag`` lags as
      split-complex [nchan_in, npol, nwin, nlag].

    Zero-padding each window by ``nlag`` makes lags < nlag free of cyclic
    wrap (the docstring contract in ``dsp/ACFilterbank.h:29-35``).
    ``window``: optional apodization of the ngood data samples.
    """
    if nlag <= 0:
        nlag = nchan // 2
    ngood = nchan - nlag
    xr, xi = x
    nwin = xr.shape[-1] // ngood

    def frame(a):
        a = a[..., : nwin * ngood].reshape(*a.shape[:-1], nwin, ngood)
        if window is not None:
            a = a * window
        pad = [(0, 0)] * (a.ndim - 1) + [(0, nchan - ngood)]
        return jnp.pad(a, pad)

    fr, fi = fft_sc((frame(xr), frame(xi)), nchan)
    # PSD = X conj(X): real |X|^2, imag 0
    psd = fr * fr + fi * fi
    if not form_acf:
        return psd, jnp.zeros_like(psd)
    ar, ai = ifft_sc((psd, jnp.zeros_like(psd)), nchan)
    return ar[..., :nlag], ai[..., :nlag]
