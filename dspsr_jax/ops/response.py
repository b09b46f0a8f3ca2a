"""Frequency response containers.

Equivalent of the reference ``dsp::Response`` (``Signal/General/dsp/Response.h:28-172``,
``Response.C``): a per-channel complex frequency response multiplied into
spectra during overlap-save convolution / filterbank construction, carrying
``impulse_pos``/``impulse_neg`` — the numbers of complex samples discarded
from the start/end of each cyclic-convolution output.

Conventions here (simpler than the reference's deferred-swap metadata):

- Responses are *built* in **natural order**: array index ``ipt`` along the
  frequency axis corresponds to frequency offset ``ipt*binwidth - chanwidth/2``
  from the channel centre, with ``binwidth = chanwidth/ndat`` **signed** by the
  bandwidth sign (reference ``Dedispersion::build``, ``Dedispersion.C:494-556``).
- :meth:`fft_order` reorders a natural-order response to match the bin order
  of the forward FFT actually performed on the data (reference
  ``Response::match``, ``Response.C:132-181``):

  * real (Nyquist) input → half-spectrum rfft bins already ascend from the
    band edge exactly like the natural order → identity;
  * complex (analytic, dual-sideband) input → FFT bin 0 is the band centre
    (DC) → ``ifftshift`` along the bin axis.

All host math is float64; the device sees complex64.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..observation import Observation


@dataclasses.dataclass
class Response:
    """Per-channel complex frequency response (natural frequency order).

    phasors: complex64[nchan, ndat]  (or [nchan, ndat, 2, 2] Jones matrices)
    """

    phasors: np.ndarray
    impulse_pos: int = 0
    impulse_neg: int = 0

    @property
    def nchan(self) -> int:
        return self.phasors.shape[0]

    @property
    def ndat(self) -> int:
        return self.phasors.shape[1]

    @property
    def impulse_total(self) -> int:
        return self.impulse_pos + self.impulse_neg

    @property
    def is_jones(self) -> bool:
        return self.phasors.ndim == 4

    def fft_order(self, complex_input: bool) -> np.ndarray:
        """Response reordered to the data's forward-FFT bin order.

        For complex input the FFT of a dual-sideband baseband block puts DC
        (band centre) at bin 0, so the natural-order response must be
        ``ifftshift``-ed (reference ``Response::doswap``/``match``,
        ``Response.C:132-181``).  Real input needs no reorder.
        """
        if complex_input:
            return np.fft.ifftshift(self.phasors, axes=1)
        return self.phasors

    def conj(self) -> "Response":
        return dataclasses.replace(self, phasors=np.conj(self.phasors))


@dataclasses.dataclass
class ResponseProduct(Response):
    """Product of several responses (reference ``ResponseProduct.C``):
    e.g. dedispersion chirp x RFI filter x polarization calibration.

    Construct via :meth:`multiply`; impulse_pos/neg are the maxima of the
    factors' (each factor smears independently).
    """

    @classmethod
    def multiply(cls, responses: List[Response]) -> "ResponseProduct":
        if not responses:
            raise ValueError("no responses to multiply")
        phasors = responses[0].phasors.astype(np.complex128)
        for r in responses[1:]:
            if r.phasors.shape != phasors.shape:
                raise ValueError(
                    f"response shape mismatch: {r.phasors.shape} vs {phasors.shape}"
                )
            phasors = phasors * r.phasors
        return cls(
            phasors=phasors.astype(np.complex64),
            impulse_pos=max(r.impulse_pos for r in responses),
            impulse_neg=max(r.impulse_neg for r in responses),
        )


def choose_nfft(nfilt_tot: int, nchan_subband: int = 1,
                max_nfft: int = 1 << 24) -> int:
    """Pick the per-channel FFT length (complex points) minimizing work/sample.

    Analytic stand-in for the reference's measured ``OptimalFFT``
    (``Signal/General/OptimalFFT.C:18-171``): FFT cost ~ N log2 N, useful
    fraction (N - nfilt_tot)/N, so minimize ``log2(N) * N/(N - nfilt_tot)``
    over powers of two.  The analytic optimum (typically 4-16x the smear)
    is the default; ``--fft-bench`` measures instead (utils.optimalfft).

    Returns the *total* forward-FFT complex length ``nchan_subband * freq_res``
    when channelizing; nfilt_tot is per output channel.
    """
    if nfilt_tot < 0:
        raise ValueError("negative smear")
    # minimum: response needs >= 2 points and must keep >= 1 sample
    n = 16
    while n <= nfilt_tot:
        n *= 2
    best_n, best_cost = None, None
    while n <= max_nfft:
        keep = n - nfilt_tot
        cost = n * np.log2(max(n, 2)) / keep
        if best_cost is None or cost < best_cost:
            best_n, best_cost = n, cost
        # cost is unimodal in n; stop once it starts rising
        if best_n is not None and n > 4 * best_n:
            break
        n *= 2
    return best_n * nchan_subband
