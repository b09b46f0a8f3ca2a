"""Software filterbank: FFT channelization with optional simultaneous
coherent dedispersion (the "convolving filterbank").

Equivalent of the reference ``dsp::Filterbank``
(``Signal/General/Filterbank.C``): each window of ``nsamp_fft`` input samples
is forward-FFT'd into ``n_fft = nchan_subband * freq_res`` bins; the spectrum
splits into ``nchan_subband`` contiguous chunks of ``freq_res`` bins; each
chunk is (optionally response-multiplied and) inverse-FFT'd into a complex
subband time series at rate ``rate * freq_res / nsamp_fft``, keeping
``nkeep = freq_res - nfilt_tot`` samples per window from offset ``nfilt_pos``
(``Filterbank.C:477-670``).  When ``freq_res == 1`` the spectrum bins *are*
the output samples (critically-sampled filterbank, ``Filterbank.C:625-637``).

Where the reference loops chan x part x pol x subchannel through FFTW
(``Filterbank.C:563-655``), here both FFTs are batched transforms
(ops.mxfft) over split-complex (re, im) pairs: one forward FFT per window
and one batch of npart x nchan_subband small inverse FFTs.

Channel ordering: outputs are in **natural order** — output channel c has
centre frequency ``obs.centre_frequency_of(c)`` — via an fftshift expressed
as a static two-slice concat; the reference instead leaves FFT order and
sets swap metadata flags (``Filterbank.C:357-364``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..observation import Observation, Signal
from .convolution import frame, frame_sc
from . import sc
from .mxfft import fft_sc, ifft_sc, rfft_sc, fftshift_sc, ifftshift_sc

SC = sc.SC


@dataclass(frozen=True)
class FilterbankPlan:
    """Static geometry (reference ``Filterbank::make_preparations``,
    ``Filterbank.C:55-263``)."""

    real_input: bool
    nchan_subband: int  # output channels per input channel
    freq_res: int  # complex points per subband per window
    nfilt_pos: int = 0
    nfilt_neg: int = 0

    @property
    def n_fft(self) -> int:
        return self.nchan_subband * self.freq_res

    @property
    def nfilt_tot(self) -> int:
        return self.nfilt_pos + self.nfilt_neg

    @property
    def nsamp_fft(self) -> int:
        return 2 * self.n_fft if self.real_input else self.n_fft

    @property
    def nsamp_overlap(self) -> int:
        """Input samples of window overlap (``Filterbank.C:141-152``)."""
        mult = 2 if self.real_input else 1
        return mult * self.nfilt_tot * self.nchan_subband

    @property
    def nsamp_step(self) -> int:
        return self.nsamp_fft - self.nsamp_overlap

    @property
    def nkeep(self) -> int:
        """Output samples kept per window per subband."""
        return self.freq_res - self.nfilt_tot

    def npart(self, ndat: int) -> int:
        if ndat <= self.nsamp_overlap:
            return 0
        return (ndat - self.nsamp_overlap) // self.nsamp_step

    def block_ndat(self, npart: int) -> int:
        return npart * self.nsamp_step + self.nsamp_overlap

    def output_ndat(self, npart: int) -> int:
        return npart * self.nkeep

    def validate(self):
        if self.freq_res <= self.nfilt_tot:
            raise ValueError(
                f"freq_res={self.freq_res} <= nfilt_tot={self.nfilt_tot}"
            )
        if self.nchan_subband < 1:
            raise ValueError("nchan_subband must be >= 1")


def forward_spectra_chunked(x, plan: FilterbankPlan, npart: int,
                            apodization=None) -> SC:
    """Frame + forward FFT + natural-order chunking.

    Returns split-complex ``[nchan_out, npol, npart, freq_res]`` where output
    channel ``c = ichan_in*nchan_subband + isub`` (natural order).  This is
    the pre-subband-inversion half of the filterbank; the sharded pipeline
    slices the channel axis here (channel parallelism lives between the big
    forward FFT and the per-subband work, reference ``MPITrans``).
    """
    plan.validate()
    if plan.real_input:
        nchan_in, npol = x.shape[0], x.shape[1]
        w = frame(x, plan.nsamp_fft, plan.nsamp_step, npart)
        if apodization is not None:
            # taper each window before the forward FFT (reference applies
            # Apodization inside Convolution, Convolution.C:379-387)
            w = w * apodization
        spec = rfft_sc(w, plan.nsamp_fft)  # natural order already
    else:
        nchan_in, npol = x[0].shape[0], x[0].shape[1]
        w = frame_sc(x, plan.nsamp_fft, plan.nsamp_step, npart)
        if apodization is not None:
            w = (w[0] * apodization, w[1] * apodization)
        spec = fftshift_sc(fft_sc(w, plan.n_fft))  # DC-centred -> natural

    def chunk(a):
        a = a.reshape(nchan_in, npol, npart, plan.nchan_subband, plan.freq_res)
        a = jnp.moveaxis(a, 3, 1)
        return a.reshape(nchan_in * plan.nchan_subband, npol, npart,
                         plan.freq_res)

    return chunk(spec[0]), chunk(spec[1])


def apply_response_chunked(spec: SC, response_natural: SC,
                           rfi_zap: Optional[tuple] = None,
                           nchan_sub_present: Optional[int] = None) -> SC:
    """Multiply a per-output-channel natural-order response into chunked
    spectra ``[nchan, npol, npart, freq_res]`` ("convolve during"); optional
    in-step narrow-band RFI rejection (ops.rfifilter).

    ``nchan_sub_present``: how many consecutive channels of the chunked axis
    form one input channel's subband group (for the RFI median bandpass —
    the median runs across each input channel's full band); defaults to all
    channels present (nchan_in == 1 or a channel-sharded slice).
    """
    if response_natural is not None:
        rr, ri = response_natural
        nchan = spec[0].shape[0]
        rr = rr.reshape(nchan, spec[0].shape[-1])
        ri = ri.reshape(nchan, spec[0].shape[-1])
        spec = sc.mul(spec, (rr[:, None, None, :], ri[:, None, None, :]))
    if rfi_zap is not None:
        from .rfifilter import rfi_bandpass_weights

        width, thresh = rfi_zap
        nchan, npol, npart, fr = spec[0].shape
        nsub = nchan_sub_present or nchan
        # [nchan_in, npol, npart, nsub, fr] view for the cross-band median
        def group(a):
            a = a.reshape(nchan // nsub, nsub, npol, npart, fr)
            return jnp.moveaxis(a, 1, 3)

        def ungroup(a):
            a = jnp.moveaxis(a, 3, 1)
            return a.reshape(nchan, npol, npart, fr)

        v = (group(spec[0]), group(spec[1]))
        w = rfi_bandpass_weights(v, width, thresh)
        w = jnp.broadcast_to(w, v[0].shape)
        spec = (ungroup(v[0] * w), ungroup(v[1] * w))
    return spec


def invert_subbands(spec: SC, plan: FilterbankPlan) -> SC:
    """Per-subband inverse FFT + keep: chunked spectra
    ``[nchan, npol, npart, freq_res]`` -> time series
    ``[nchan, npol, npart*nkeep]`` (complex baseband per channel)."""
    nchan, npol, npart = spec[0].shape[0], spec[0].shape[1], spec[0].shape[2]
    if plan.freq_res == 1:
        return spec[0][..., 0], spec[1][..., 0]
    chunks = ifftshift_sc(spec)
    tr, ti = ifft_sc(chunks, plan.freq_res)

    def keep(a):
        k = a[..., plan.nfilt_pos : plan.nfilt_pos + plan.nkeep]
        return k.reshape(nchan, npol, npart * plan.nkeep)

    return keep(tr), keep(ti)


@partial(jax.jit, static_argnames=("plan", "npart", "rfi_zap"))
def filterbank_block(
    x,
    plan: FilterbankPlan,
    npart: int,
    response_natural: Optional[SC] = None,
    rfi_zap: Optional[tuple] = None,
    apodization=None,
) -> SC:
    """Channelize a block (optionally convolving a response).

    Args:
      x: ``[nchan_in, npol, ndat]`` voltages — float32 if real input, else a
        split-complex pair; ``ndat == plan.block_ndat(npart)``.
      response_natural: optional split-complex
        ``[nchan_in*nchan_subband, freq_res]`` per-output-channel response in
        natural order ("convolve during", reference ``FilterbankConfig``
        convolve_when==During).
      rfi_zap: optional (median_width, threshold) enabling in-step
        narrow-band RFI rejection (ops.rfifilter; reference RFIFilter).

    Returns split-complex ``[nchan_in*nchan_subband, npol, npart*nkeep]`` in
    natural channel order.
    """
    spec = forward_spectra_chunked(x, plan, npart, apodization)
    spec = apply_response_chunked(spec, response_natural, rfi_zap,
                                  nchan_sub_present=plan.nchan_subband)
    return invert_subbands(spec, plan)


def update_observation(obs: Observation, plan: FilterbankPlan) -> Observation:
    """Metadata transition applied by the filterbank
    (``Filterbank::prepare_output``, ``Filterbank.C:265-380``)."""
    ratechange = plan.freq_res / plan.nsamp_fft
    return obs.replace(
        nchan=obs.nchan * plan.nchan_subband,
        ndim=2,
        state=Signal.ANALYTIC,
        rate=obs.rate * ratechange,
        # our subbands are proper complex baseband (subband centre at DC after
        # the intra-chunk ifftshift), i.e. dual-sideband; channel centre
        # frequencies follow the standard (not-dc_centred) mapping
        dc_centred=False,
        dual_sideband=plan.freq_res > 1,
    )
