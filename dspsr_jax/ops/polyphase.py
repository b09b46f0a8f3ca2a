"""Polyphase filterbank (weighted overlap-add channelizer).

Equivalent of the reference ``dsp::PolyPhaseFilterbank``
(``Signal/General/PolyPhaseFilterbank.C``): an alternative channelizer with
far better channel isolation than the plain FFT filterbank, at the cost of a
prototype FIR filter of ``ntaps`` per channel.

Formulation: for nchan channels and T taps, output sample t of the
polyphase front end is::

    s[c', t] = sum_j h[j*nchan + c'] x[t*nchan + j*nchan + c']   (j = 0..T-1)

i.e. frame x into [npart, T, nchan], weight by the reshaped prototype filter
h[T, nchan] and sum over taps (one fused multiply-reduce), then FFT across
the channel axis (ops.mxfft).  Critically sampled (decimation == nchan).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import sc
from .mxfft import fft_sc, fftshift_sc
from .convolution import frame, frame_sc

SC = sc.SC


def prototype_lowpass(nchan: int, ntaps: int, beta: float = 1.0) -> np.ndarray:
    """Windowed-sinc prototype filter, cutoff at the channel width.

    float32[ntaps*nchan], normalized to unit DC gain per channel.
    """
    n = ntaps * nchan
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    x = t / nchan * beta
    h = np.sinc(x)
    h *= np.hamming(n)
    h /= h.sum()  # unit gain for a tone at any channel centre
    return h.astype(np.float32)


@dataclass(frozen=True)
class PolyphasePlan:
    real_input: bool
    nchan_subband: int
    ntaps: int = 8

    @property
    def window_samples(self) -> int:
        return self.ntaps * self.nchan_subband

    @property
    def step(self) -> int:
        return self.nchan_subband  # critically sampled

    def npart(self, ndat: int) -> int:
        if ndat < self.window_samples:
            return 0
        return (ndat - self.window_samples) // self.step + 1

    def block_ndat(self, npart: int) -> int:
        return (npart - 1) * self.step + self.window_samples


@partial(jax.jit, static_argnames=("plan", "npart"))
def polyphase_filterbank_block(
    x,
    h: jnp.ndarray,
    plan: PolyphasePlan,
    npart: int,
) -> SC:
    """Channelize with the polyphase front end.

    Args:
      x: [nchan_in, npol, ndat] float32 (real input) or split-complex pair.
      h: float32[ntaps*nchan_subband] prototype filter.

    Returns split-complex [nchan_in*nchan_subband, npol, npart] in natural
    channel order (one output sample per window: critical sampling).
    """
    nc = plan.nchan_subband
    hw = h.reshape(plan.ntaps, nc)

    # half-channel input shift: the canonical PFB puts channel centres on
    # integer multiples of 1/nc (dc-centred); multiplying the input by
    # exp(-i pi n / nc) moves the spectrum down half a channel so centres
    # follow the framework's non-dc-centred convention (channel c centre =
    # obs.centre_frequency_of(c)).  The ramp is periodic (period 2*nc) so the
    # phase argument stays tiny regardless of block length.
    if plan.real_input:
        xr, xi = x, None
    else:
        xr, xi = x
    ndat = xr.shape[-1]
    n_mod = jax.lax.broadcasted_iota(jnp.int32, (1, ndat), 1)[0] % (2 * nc)
    ang = (np.pi / nc) * n_mod.astype(jnp.float32)
    rr = jnp.cos(ang)
    ri = -jnp.sin(ang)
    if xi is None:
        yr_in = xr * rr
        yi_in = xr * ri
    else:
        yr_in = xr * rr - xi * ri
        yi_in = xr * ri + xi * rr

    def front(a):
        w = frame(a, plan.window_samples, plan.step, npart)
        # [nchan_in, npol, npart, ntaps*nchan_sub] -> weighted tap sum
        w = w.reshape(*w.shape[:-1], plan.ntaps, nc)
        return jnp.sum(w * hw, axis=-2)  # [nchan_in, npol, npart, nchan_sub]

    spec = fftshift_sc(fft_sc((front(yr_in), front(yi_in)), nc))

    # [nchan_in, npol, npart, nchan_sub] -> [nchan_in*nchan_sub, npol, npart]
    def out(a):
        nchan_in, npol = a.shape[0], a.shape[1]
        return jnp.moveaxis(a, 3, 1).reshape(nchan_in * nc, npol, npart)

    return out(spec[0]), out(spec[1])
