"""Persistent compilation cache for the CLI apps.

The reference amortizes plan creation with FFTW wisdom / the OptimalFFT
cost-table cache (``Signal/General/OptimalFFT.C``); the XLA analogue is
JAX's on-disk executable cache.  CLI apps call
:func:`enable_compilation_cache` before their first computation.  The
platform itself is JAX's choice (``JAX_PLATFORMS``).
"""

from __future__ import annotations

import os

#: the checkout root: the directory holding the ``dspsr_jax`` package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """Directory for compiled programs and measured FFT tables:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` in the
    checkout (a fixed path, since the path is part of the cache key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and no
    other directory is configured here."""
    import jax

    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # cache every compile that took longer than a second (CLI compiles of
    # a new geometry take tens of seconds)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
