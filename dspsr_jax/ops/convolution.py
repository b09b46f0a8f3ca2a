"""Overlap-save FFT convolution on device.

Equivalent of the reference ``dsp::Convolution``
(``Signal/General/Convolution.C:100-461``): each block of voltages is framed
into ``npart`` overlapping windows of ``nsamp_fft`` samples stepped by
``nsamp_step = nsamp_fft - nsamp_overlap``; each window is forward-FFT'd,
multiplied by the (chirp) frequency response, inverse-FFT'd, and the first
``nfilt_pos`` / last ``nfilt_neg`` complex samples of each window are
discarded (cyclic-convolution wrap-around pollution).

Where the reference loops chan x pol x part calling FFTW per window
(``Convolution.C:389-461``), here all windows of all channels and
polarizations go through one batched FFT (ops.mxfft) — complex data is
split-complex (re, im) float32 pairs (ops.sc).

Real (Nyquist) input follows the reference convention
(``Convolution.C:170-189``): the forward FFT of ``nsamp_fft = 2*n_fft`` real
samples yields ``n_fft`` positive-frequency bins treated as the spectrum of
an *analytic* signal at half the sampling rate; output is complex with
``ndat_out = npart*nsamp_step/2``.

FFT normalization: forward unscaled, inverse 1/N (numpy convention) — unit
convolution gain, so output scale == input scale (the reference instead
tracks an ``nsamp_fft*n_fft`` factor to divide out later,
``Convolution.C:303-305``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..observation import Observation, Signal
from .response import Response
from . import sc
from .mxfft import fft_sc, ifft_sc, rfft_sc

SC = sc.SC


@dataclass(frozen=True)
class OverlapSavePlan:
    """Static geometry of the overlap-save streaming convolution.

    Mirrors ``Convolution::prepare`` (``Convolution.C:105-221``).
    All counts are in *input* samples unless suffixed ``_c`` (complex samples
    at the analytic rate).
    """

    real_input: bool  # Signal::Nyquist input (float), else Analytic (complex)
    n_fft: int  # complex points per window after forward FFT
    nfilt_pos: int  # complex samples dropped from each window head
    nfilt_neg: int  # complex samples dropped from each window tail

    @property
    def nfilt_tot(self) -> int:
        return self.nfilt_pos + self.nfilt_neg

    @property
    def nsamp_fft(self) -> int:
        """Input samples per forward FFT (``Convolution.C:170-189``)."""
        return 2 * self.n_fft if self.real_input else self.n_fft

    @property
    def nsamp_overlap(self) -> int:
        return 2 * self.nfilt_tot if self.real_input else self.nfilt_tot

    @property
    def nsamp_step(self) -> int:
        return self.nsamp_fft - self.nsamp_overlap

    @property
    def nkeep_c(self) -> int:
        """Complex output samples kept per window."""
        return self.n_fft - self.nfilt_tot

    def npart(self, ndat: int) -> int:
        """Windows that fit in ``ndat`` input samples (``Filterbank.C:402``)."""
        if ndat <= self.nsamp_overlap:
            return 0
        return (ndat - self.nsamp_overlap) // self.nsamp_step

    def block_ndat(self, npart: int) -> int:
        """Input samples consumed by ``npart`` windows (incl. trailing overlap)."""
        return npart * self.nsamp_step + self.nsamp_overlap

    def output_ndat(self, npart: int) -> int:
        """Complex output samples for npart windows."""
        return npart * self.nkeep_c

    def validate(self):
        if self.n_fft < 2:
            raise ValueError("FFT too small")
        if self.nkeep_c <= 0:
            raise ValueError(
                f"n_fft={self.n_fft} <= nfilt_tot={self.nfilt_tot}: "
                "FFT length must exceed the smearing"
            )


def frame(x: jnp.ndarray, nsamp_fft: int, nsamp_step: int, npart: int) -> jnp.ndarray:
    """Frame the trailing time axis into overlapping windows.

    x[..., ndat] -> [..., npart, nsamp_fft] with window p starting at
    p*nsamp_step (the overlap-save tiling; reference ``Convolution.C:389-391``).

    Gather-free and O(k) program size: reshape to step-sized rows, then
    concatenate k = ceil(nfft/step) shifted row views and trim — window p is
    rows p..p+k-1 of the reshaped signal.  k == 1 (pure reshape) when there
    is no overlap; k == 2 for the usual overlap < step case.
    """
    if nsamp_step == nsamp_fft:
        head = x[..., : npart * nsamp_step]
        return head.reshape(*x.shape[:-1], npart, nsamp_fft)
    k = -(-nsamp_fft // nsamp_step)
    rows_needed = npart + k - 1
    flat_needed = rows_needed * nsamp_step
    if x.shape[-1] < flat_needed:
        # zero-pad the tail: padding is only ever read by shifted views past
        # the last window's end, which the final [..., :nsamp_fft] trim drops
        pad = [(0, 0)] * (x.ndim - 1) + [(0, flat_needed - x.shape[-1])]
        y = jnp.pad(x, pad)
    else:
        y = x[..., :flat_needed]
    y = y.reshape(*x.shape[:-1], rows_needed, nsamp_step)
    shifted = [
        jax.lax.slice_in_dim(y, i, i + npart, axis=-2) for i in range(k)
    ]
    stacked = jnp.concatenate(shifted, axis=-1)  # [..., npart, k*step]
    return stacked[..., :nsamp_fft]


def frame_sc(x: SC, nsamp_fft: int, nsamp_step: int, npart: int) -> SC:
    return (frame(x[0], nsamp_fft, nsamp_step, npart),
            frame(x[1], nsamp_fft, nsamp_step, npart))


def forward_spectra(x: Union[jnp.ndarray, SC], plan: OverlapSavePlan,
                    npart: int, apodization=None) -> SC:
    """Frame + forward FFT -> split-complex spectra [..., npart, n_fft] in
    FFT bin order.

    ``apodization``: optional float32[nsamp_fft] taper applied to each
    window before the forward FFT (reference Convolution.C:379-387)."""
    if plan.real_input:
        w = frame(x, plan.nsamp_fft, plan.nsamp_step, npart)
        if apodization is not None:
            w = w * apodization
        return rfft_sc(w, plan.nsamp_fft)
    w = frame_sc(x, plan.nsamp_fft, plan.nsamp_step, npart)
    if apodization is not None:
        w = (w[0] * apodization, w[1] * apodization)
    return fft_sc(w, plan.n_fft)


def _natural(a, plan: OverlapSavePlan):
    """FFT bin order -> natural (ascending frequency) order along the last
    axis; real-input half spectra are natural already (Response.fft_order)."""
    return a if plan.real_input else jnp.fft.fftshift(a, axes=-1)


def _fft_order(a, plan: OverlapSavePlan):
    return a if plan.real_input else jnp.fft.ifftshift(a, axes=-1)


def bandpass(spec: SC, plan: OverlapSavePlan) -> jnp.ndarray:
    """Pre-response bandpass of one block: power summed over windows,
    natural order ``[nchan, npol, n_fft]`` (reference Response passband
    integration during Convolution)."""
    return _natural(jnp.sum(sc.abs2(spec), axis=-2), plan)


def zap_rfi(spec: SC, plan: OverlapSavePlan, width: int,
            threshold: float) -> SC:
    """Narrow-band RFI zap of one block from its own pre-response spectra
    (ops.rfifilter; the same-block semantics of the filterbank path's
    ``apply_response_chunked``): per (channel, polarization), bins whose
    window-averaged power exceeds ``threshold`` times the running median
    across the channel's band are zeroed in every window."""
    from .rfifilter import rfi_bandpass_weights

    nat = (_natural(spec[0], plan)[..., None, :],
           _natural(spec[1], plan)[..., None, :])
    w = rfi_bandpass_weights(nat, width, threshold)[..., 0, :]
    w = _fft_order(w, plan)
    return spec[0] * w, spec[1] * w


def apply_response(spec: SC, response_fft_order: SC) -> SC:
    """Multiply the per-channel response ``[nchan, n_fft]`` into spectra
    ``[nchan, npol, npart, n_fft]``."""
    rr, ri = response_fft_order
    return sc.mul(spec, (rr[:, None, None, :], ri[:, None, None, :]))


def apply_jones(spec: SC, response_fft_order: Tuple[SC, SC, SC, SC]) -> SC:
    """2x2 polarization mix per frequency bin (matrix convolution,
    reference ``Convolution.C:425-436``): response (J00, J01, J10, J11),
    each split-complex ``[nchan, n_fft]``; spectra ``[nchan, 2, npart,
    n_fft]``."""
    sr, si = spec
    p = (sr[:, 0], si[:, 0])
    q = (sr[:, 1], si[:, 1])
    j00, j01, j10, j11 = [
        (r[:, None, :], i[:, None, :]) for (r, i) in response_fft_order
    ]
    op = sc.add(sc.mul(j00, p), sc.mul(j01, q))
    oq = sc.add(sc.mul(j10, p), sc.mul(j11, q))
    return (jnp.stack([op[0], oq[0]], axis=1),
            jnp.stack([op[1], oq[1]], axis=1))


def invert_windows(spec: SC, plan: OverlapSavePlan) -> SC:
    """Inverse FFT + keep: spectra ``[nchan, npol, npart, n_fft]`` ->
    ``[nchan, npol, npart*nkeep_c]`` analytic voltages."""
    tr, ti = ifft_sc(spec, plan.n_fft)
    nchan, npol, npart = tr.shape[:3]
    out = npart * plan.nkeep_c

    def keep(a):
        a = a[..., plan.nfilt_pos : plan.nfilt_pos + plan.nkeep_c]
        return a.reshape(nchan, npol, out)

    return keep(tr), keep(ti)


@partial(jax.jit, static_argnames=("plan", "npart"))
def overlap_save_convolve(
    x,
    response_fft_order: SC,
    plan: OverlapSavePlan,
    npart: int,
    apodization=None,
) -> SC:
    """Convolve a block with a per-channel frequency response.

    Args:
      x: voltages — float32 ``[nchan, npol, ndat]`` when ``plan.real_input``,
        else a split-complex pair of such arrays.
        ``ndat`` must equal ``plan.block_ndat(npart)``.
      response_fft_order: split-complex ``[nchan, n_fft]`` already in FFT bin
        order (see ``Response.fft_order``).
      plan, npart: static geometry.

    Returns split-complex ``[nchan, npol, npart*nkeep_c]`` analytic voltages.
    """
    plan.validate()
    spec = forward_spectra(x, plan, npart, apodization)
    return invert_windows(apply_response(spec, response_fft_order), plan)


@partial(jax.jit, static_argnames=("plan", "npart"))
def overlap_save_convolve_jones(
    x,
    response_fft_order: Tuple[SC, SC, SC, SC],
    plan: OverlapSavePlan,
    npart: int,
    apodization=None,
) -> SC:
    """Matrix (Jones) convolution: full 2x2 polarization response
    (reference ``Convolution.C:425-436`` matrix_convolution path).

    Args:
      x: ``[nchan, 2, ndat]`` voltages (float32 if real input, else SC pair).
      response_fft_order: 2x2 of split-complex ``[nchan, n_fft]``:
        ((J00, J01), (J10, J11)) flattened as (J00, J01, J10, J11).

    Returns split-complex ``[nchan, 2, npart*nkeep_c]``.
    """
    plan.validate()
    spec = forward_spectra(x, plan, npart, apodization)
    return invert_windows(apply_jones(spec, response_fft_order), plan)


def make_plan(obs: Observation, response: Response, n_fft: int | None = None) -> OverlapSavePlan:
    """Build a plan from observation state + response smear, choosing the FFT
    length if not given (reference ``Convolution::prepare`` +
    ``Response::set_optimal_ndat``)."""
    from .response import choose_nfft

    real_input = obs.state == Signal.NYQUIST
    nfilt_tot = response.impulse_total
    if n_fft is None:
        n_fft = choose_nfft(nfilt_tot)
    plan = OverlapSavePlan(
        real_input=real_input,
        n_fft=n_fft,
        nfilt_pos=response.impulse_pos,
        nfilt_neg=response.impulse_neg,
    )
    plan.validate()
    return plan
