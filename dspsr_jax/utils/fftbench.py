"""FFT / filterbank kernel micro-benchmark.

Equivalent of the reference ``filterbank_speed`` / ``fftbatch_speed``
(``Signal/General/filterbank_speed.C:189-221``): sweep transform lengths and
batch sizes, print time per transform and the reference's MFLOPS figure
``5*nfft*nchan*(log2 nfft + log2 nchan)/t_us``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fftbench")
    ap.add_argument("--nfft", type=int, nargs="+",
                    default=[4096, 65536, 1 << 20])
    ap.add_argument("--nchan", type=int, nargs="+", default=[1, 64, 1024])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)

    from .platform import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from ..ops.mxfft import fft_sc

    dev = jax.devices()[0]
    print(f"# {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    rng = np.random.default_rng(0)
    print(f"{'nchan':>6s} {'nfft':>9s} "
          f"{'t/xform(us)':>12s} {'MFLOPS':>10s} {'Mcsamp/s':>9s}")
    for nchan in args.nchan:
        for nfft in args.nfft:
            n = nchan * nfft
            if n > (1 << 24):
                continue
            x = (jnp.asarray(rng.standard_normal((args.batch, n)).astype(np.float32)),
                 jnp.asarray(rng.standard_normal((args.batch, n)).astype(np.float32)))
            f = jax.jit(lambda a, b: fft_sc((a, b), n))
            y = f(*x)
            jax.block_until_ready(y)
            t0 = time.perf_counter()
            for _ in range(args.trials):
                y = f(*x)
            jax.block_until_ready(y)
            dt = (time.perf_counter() - t0) / (args.trials * args.batch)
            t_us = dt * 1e6
            mflops = 5 * nfft * nchan * (np.log2(nfft) + np.log2(max(nchan, 2))) / t_us
            print(f"{nchan:6d} {nfft:9d} "
                  f"{t_us:12.1f} {mflops:10.0f} {n / dt / 1e6:9.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
