"""Narrow-band RFI rejection from the median-filtered bandpass.

Equivalent of the reference ``dsp::RFIFilter``
(``Signal/General/RFIFilter.C``): estimate the bandpass, median-filter it
across frequency, and zero response bins whose power exceeds the local
median by a threshold — rejecting narrow-band interference before
detection.  The reference recomputes this on a time interval and multiplies
it into the convolution response via ResponseProduct; here the weights are
computed **inside the per-block device step** from that block's own spectra
(the running median is exact), making the filter fully time-adaptive at
zero host cost.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import sc

SC = sc.SC


@partial(jax.jit, static_argnames=("width",))
def median_filter_freq(bandpass: jnp.ndarray, width: int) -> jnp.ndarray:
    """Running median over the last (frequency) axis, edge-replicated.

    bandpass: float32[..., nfreq]; width must be odd.

    The window values are sorted with an odd-even transposition network of
    elementwise min/max over the ``width`` shifted views, which XLA fuses
    into one elementwise pass over the band.
    """
    if width < 3 or width % 2 == 0:
        # w[width//2] is the true median only for odd widths; an even
        # value would silently yield an off-center order statistic
        raise ValueError(f"median width must be odd and >= 3, got {width}")
    half = width // 2
    pad = [(0, 0)] * (bandpass.ndim - 1) + [(half, half)]
    padded = jnp.pad(bandpass, pad, mode="edge")
    w = [
        jax.lax.slice_in_dim(padded, i, i + bandpass.shape[-1], axis=-1)
        for i in range(width)
    ]
    for r in range(width):
        for i in range(r % 2, width - 1, 2):
            lo = jnp.minimum(w[i], w[i + 1])
            hi = jnp.maximum(w[i], w[i + 1])
            w[i], w[i + 1] = lo, hi
    return w[half]


@partial(jax.jit, static_argnames=("width",))
def rfi_bandpass_weights(spec: SC, width: int = 21,
                         threshold: float = 4.0) -> jnp.ndarray:
    """Per-frequency-bin zap weights from the block's own spectra.

    spec: split-complex [..., npart, nchan_sub, freq_res] (the convolving
    filterbank's chunked spectra).  The bandpass is the power averaged over
    windows/pols; bins with power > threshold * local_median get weight 0.

    Returns float32[..., 1, nchan_sub, freq_res] broadcastable weights.
    """
    power = spec[0] * spec[0] + spec[1] * spec[1]
    # average over part (and any leading pol axes beyond channel structure)
    bp = jnp.mean(power, axis=-3, keepdims=True)  # [..., 1, nchan_sub, fr]
    shape = bp.shape
    flat = bp.reshape(*shape[:-2], shape[-2] * shape[-1])
    med = median_filter_freq(flat, width)
    good = flat <= threshold * jnp.maximum(med, 1e-30)
    return good.astype(jnp.float32).reshape(shape)
