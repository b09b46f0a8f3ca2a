"""FFTs over split-complex tensors.

The pipeline's stages exchange complex data as split-complex (re, im)
float32 pairs (ops.sc).  These wrappers convert to complex64 and call
``jnp.fft``, which XLA lowers to the platform's FFT library (cuFFT on an
NVIDIA GPU, DUCC on the CPU) — the role of the reference's FFTW/CUFFT
wrappers (``FTransform``; see SURVEY.md §2.7).

Conventions follow numpy: forward unscaled, inverse scaled by 1/N, output
in natural FFT bin order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sc import SC


def _check_len(a: jnp.ndarray, n: int) -> None:
    if a.shape[-1] != n:
        raise ValueError(f"transform length {n} != last axis {a.shape[-1]}")


def fft_sc(x: SC, n: int, forward: bool = True) -> SC:
    """Complex FFT of length ``n`` along the last axis."""
    _check_len(x[0], n)
    z = jax.lax.complex(x[0], x[1])
    z = jnp.fft.fft(z, axis=-1) if forward else jnp.fft.ifft(z, axis=-1)
    return jnp.real(z), jnp.imag(z)


def ifft_sc(x: SC, n: int) -> SC:
    return fft_sc(x, n, forward=False)


def rfft_sc(x: jnp.ndarray, n2: int) -> SC:
    """Real-input FFT of length ``n2`` (= 2N real samples) along the last
    axis; returns bins 0..N-1 (the Nyquist bin is dropped, matching how the
    pipeline consumes half-spectra; reference ``frc1d`` semantics)."""
    _check_len(x, n2)
    z = jnp.fft.rfft(x, axis=-1)[..., : n2 // 2]
    return jnp.real(z), jnp.imag(z)


def fftshift_sc(x: SC, axis: int = -1) -> SC:
    return jnp.fft.fftshift(x[0], axes=axis), jnp.fft.fftshift(x[1], axes=axis)


def ifftshift_sc(x: SC, axis: int = -1) -> SC:
    return (jnp.fft.ifftshift(x[0], axes=axis),
            jnp.fft.ifftshift(x[1], axes=axis))
