"""SKA1 Band-2-style sizing run: 81 coarse channels -> 1296 output channels.

Mirrors the reference's SKA1 pipeline sizing example
(``Benchmark/examples/SKA1/Band2``: BW 810 MHz delivered as 81 x 10 MHz
critically-sampled subbands, dspsr builds a convolving filterbank to 1296
output channels; the reference job used 2 GPUs).  Here the same geometry
maps onto a ``(time, chan)`` device mesh: the chan axis divides the 81
INPUT channels (81 = 3^4), so each shard owns a group of output channels
between the forward FFT and the per-subband inversion — the MPITrans
channel scatter (``parallel/pipeline.py``).

By default this runs a SCALED-DOWN geometry on a virtual 6-device CPU
mesh (2 time x 3 chan, 9 input channels x 4 subbands) and verifies the
sharded result against the single-device run; pass ``--full`` on a
multi-GPU machine for the full 81-channel configuration.

Run: python examples/ska1_band2.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FULL = "--full" in sys.argv
if not FULL:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=6")


def main():
    import jax

    if not FULL:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 6)
    import dataclasses

    import numpy as np

    from dspsr_jax.io.sources import RawFileSource
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
    from dspsr_jax.observation import Observation, Signal
    from dspsr_jax.parallel.pipeline import ShardedFoldPipeline
    from dspsr_jax.parallel.sharded import make_mesh
    from dspsr_jax.timing.mjd import MJD

    if FULL:
        nchan_in, nsub, n_time, n_chan = 81, 16, len(jax.devices()) // 3, 3
        rate, ndat = 10e6, 1 << 24
    else:
        nchan_in, nsub, n_time, n_chan = 9, 4, 2, 3
        rate, ndat = 1e6, 1 << 18

    obs = Observation(
        nchan=nchan_in, npol=2, ndim=2, nbit=8,
        centre_frequency=1355.0, bandwidth=-10.0 * nchan_in, rate=rate,
        start_time=MJD.from_utc("2021-01-01-00:00:00"),
        state=Signal.ANALYTIC, source="J0437-4715", telescope="MeerKAT",
        instrument="RAW")

    rng = np.random.default_rng(0)

    def write(nsamp):
        raw = rng.integers(0, 256, nsamp * nchan_in * 2 * 2, dtype=np.uint8)
        path = "/tmp/ska1_band2.raw"
        with open(path, "wb") as f:
            f.write(raw.tobytes())
        return path

    cfg = FoldConfig(
        folding_period=0.005757, dispersion_measure=2.64,
        nchan=nchan_in * nsub, nbin=256 if FULL else 64,
        min_block_samples=1 << (22 if FULL else 14),
        block_parts=2, digitizer_stats=False)

    mesh = make_mesh(n_time * n_chan, n_chan)
    # size the file to whole superblocks so the sharded and single runs
    # integrate exactly the same span (the sharded driver streams whole
    # superblocks)
    probe = ShardedFoldPipeline(RawFileSource(write(ndat), obs), cfg, mesh)
    nsamp = 2 * probe.superblock_stride + probe.inner.nsamp_overlap
    path = write(nsamp)
    sh = ShardedFoldPipeline(RawFileSource(path, obs), cfg, mesh)
    print(f"mesh (time={n_time}, chan={n_chan}); "
          f"{nchan_in} input channels x {nsub} subbands -> "
          f"{nchan_in * nsub} output channels")
    res = sh.run()
    print("sharded profiles:", res.profiles.shape,
          "hits:", float(np.asarray(res.hits).sum()))

    if not FULL:
        single = FoldPipeline(RawFileSource(path, obs), cfg)
        ref = single.run()
        scale = np.abs(ref.profiles).max()
        err = np.abs(res.profiles - ref.profiles).max() / scale
        print(f"sharded vs single-chip max rel err: {err:.2e}")
        assert err < 1e-5


if __name__ == "__main__":
    main()
