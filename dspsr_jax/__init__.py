"""dspsr_jax: pulsar baseband signal processing in JAX.

A from-scratch JAX/XLA framework with the capabilities of dspsr
(van Straten & Bailes 2011): baseband ingestion and n-bit unpacking,
phase-coherent dedispersion by overlap-save FFT convolution, software
filterbank channelization (including the convolving filterbank), full-Stokes
detection, spectral-kurtosis RFI excision, and folding against TEMPO polycos
into phase-resolved sub-integration archives — expressed as sharded JAX
programs over a device mesh instead of pthreads + CUDA + MPI.

Layout:
    observation   Observation metadata (dsp::Observation equivalent)
    timing        MJD, TEMPO polyco predictor, .par ephemerides
    io            DADA/SIGPROC/archive readers & writers, format registry
    unpack        n-bit unpackers (bit tables, 2-bit dynamic levels, excision)
    ops           device DSP kernels (chirp, convolution, filterbank,
                  detection, fold, scrunch, rescale, SK ...)
    models        pipeline builders (LoadToFold / LoadToFil equivalents)
    parallel      mesh/sharding/halo-exchange for multi-chip runs
    utils         small shared helpers
"""

__version__ = "0.1.0"

from .observation import Observation, Signal, Basis  # noqa: F401
from .timing.mjd import MJD  # noqa: F401
