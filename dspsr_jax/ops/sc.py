"""Split-complex arithmetic: complex tensors as (real, imag) float32 pairs.

The device pipeline carries every complex tensor as a pair of float32
arrays; the FFT layer (ops.mxfft) converts to complex64 at its boundary.
These helpers keep the call sites readable; XLA fuses the component
arithmetic.

Convention: an ``SC`` is a 2-tuple ``(re, im)`` of identically-shaped float32
arrays.  Host-side numpy complex converts at the boundary.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

SC = Tuple[jnp.ndarray, jnp.ndarray]


def from_numpy(c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    c = np.asarray(c)
    return (np.ascontiguousarray(c.real).astype(np.float32),
            np.ascontiguousarray(c.imag).astype(np.float32))


def to_numpy(x: SC) -> np.ndarray:
    return np.asarray(x[0]).astype(np.float64) + 1j * np.asarray(x[1]).astype(np.float64)


def mul(a: SC, b: SC) -> SC:
    """Elementwise complex multiply: 4 real mults (XLA fuses)."""
    ar, ai = a
    br, bi = b
    return (ar * br - ai * bi, ar * bi + ai * br)


def mul_conj(a: SC, b: SC) -> SC:
    """a * conj(b)."""
    ar, ai = a
    br, bi = b
    return (ar * br + ai * bi, ai * br - ar * bi)


def conj(a: SC) -> SC:
    return (a[0], -a[1])


def add(a: SC, b: SC) -> SC:
    return (a[0] + b[0], a[1] + b[1])


def scale(a: SC, s) -> SC:
    return (a[0] * s, a[1] * s)


def abs2(a: SC) -> jnp.ndarray:
    return a[0] * a[0] + a[1] * a[1]
