"""Measured-cost FFT length selection.

Equivalent of the reference ``dsp::OptimalFFT`` + ``FTransform::Bench``
(``Signal/General/OptimalFFT.C:18-171``, enabled by ``--fft-bench``,
``Signal/Pulsar/dspsr.C:378-380``): instead of the analytic N*log2(N) model
(``ops.response.choose_nfft``), time the actual transform on the actual
backend for each candidate length and minimize measured cost per *useful*
output sample, cost(N) = t(N) / (N - nfilt_tot).

Timings are cached in a JSON table per platform, beside the compilation
cache (utils.platform.cache_dir; the reference persists bench tables the
same way) so the sweep runs once per machine/backend.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from .platform import cache_dir


class FFTBench:
    """Measured seconds-per-transform for complex FFTs of length N."""

    def __init__(self, platform: Optional[str] = None, batch: int = 8,
                 trials: int = 5, cache: bool = True):
        import jax

        self.platform = platform or jax.default_backend()
        self.batch = batch
        self.trials = trials
        self.cache = cache
        self._table: Dict[int, float] = {}
        if cache:
            self._load()

    @property
    def _cache_path(self) -> str:
        return os.path.join(cache_dir(), f"fftbench_{self.platform}.json")

    def _load(self) -> None:
        try:
            with open(self._cache_path) as f:
                self._table = {int(k): float(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            self._table = {}

    def _save(self) -> None:
        try:
            os.makedirs(cache_dir(), exist_ok=True)
            with open(self._cache_path, "w") as f:
                json.dump({str(k): v for k, v in self._table.items()}, f)
        except OSError:
            pass  # cache is best-effort

    def time_fft(self, n: int) -> float:
        """Seconds per forward transform of length ``n`` (measured, cached)."""
        if n in self._table:
            return self._table[n]
        import jax
        import jax.numpy as jnp
        from ..ops.mxfft import fft_sc

        rng = np.random.default_rng(0)
        x = (jnp.asarray(rng.standard_normal((self.batch, n)).astype(np.float32)),
             jnp.asarray(rng.standard_normal((self.batch, n)).astype(np.float32)))
        f = jax.jit(lambda a, b: fft_sc((a, b), n))
        y = f(*x)
        np.asarray(y[0][:1, :1])  # compile + sync
        t0 = time.perf_counter()
        for _ in range(self.trials):
            y = f(*x)
        np.asarray(y[0][:1, :1])
        dt = (time.perf_counter() - t0) / (self.trials * self.batch)
        self._table[n] = dt
        if self.cache:
            self._save()
        return dt


class OptimalFFT:
    """Choose the FFT length minimizing measured cost per useful sample."""

    def __init__(self, bench: Optional[FFTBench] = None):
        self.bench = bench or FFTBench()

    def get_best_ndat(self, nfilt_tot: int, nchan_subband: int = 1,
                      max_nfft: int = 1 << 22) -> int:
        """Reference ``OptimalFFT::get_best_ndat``: scan powers of two above
        the smear; return total forward length (x nchan_subband)."""
        if nfilt_tot < 0:
            raise ValueError("negative smear")
        n = 16
        while n <= nfilt_tot:
            n *= 2
        best_n, best_cost = None, None
        rising = 0
        while n <= max_nfft:
            keep = n - nfilt_tot
            cost = self.bench.time_fft(n * nchan_subband) / keep
            if best_cost is None or cost < best_cost:
                best_n, best_cost = n, cost
                rising = 0
            else:
                rising += 1
                if rising >= 2:  # measured cost/sample is noisy-unimodal
                    break
            n *= 2
        return best_n * nchan_subband

    def compute_cost(self, nfft: int, nfilt_tot: int) -> float:
        """Measured seconds per useful output sample at length nfft."""
        return self.bench.time_fft(nfft) / max(nfft - nfilt_tot, 1)
