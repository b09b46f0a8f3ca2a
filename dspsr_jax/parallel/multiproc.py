"""Multi-process fold driver — the proven MPIRoot/MPIServer equivalent.

The reference scatters raw BitSeries blocks from a root rank to worker
ranks over MPI with ready-token flow control
(``Kernel/Classes/MPIRoot.C:318-472``, ``MPIServer.C``, packed Observation
``Observation.h:375-390``).  This design needs no root at all: every
process derives its stripe assignment from ``jax.process_index()`` and
reads its own disjoint byte ranges (``ShardedFoldPipeline`` with
``distributed=True``); the only cross-process traffic is the overlap-save
halo (``lax.ppermute`` inside the jitted step) and the tiny ``psum`` of
fold accumulators.

This module provides:

- ``worker_main``: entry point for one process — initializes
  ``jax.distributed``, builds the global mesh, streams its stripes, and
  (process 0) writes the combined FoldResult to an npz.
- ``launch_fold``: spawns N local worker processes (the ``mpirun`` role)
  over a K-virtual-CPU-device mesh each, or (``devices_per_proc=0``) one
  GPU each, and returns process 0's result.

Demonstrated by ``tests/test_multiproc.py`` (2 OS processes x 4 virtual
devices == 1 process x 8 devices == single pipeline) and by
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="dspsr-jax-worker")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices-per-proc", type=int, default=0,
                    help="force this many virtual CPU devices (0 = real)")
    ap.add_argument("--data", required=True, help="input file (DADA etc.)")
    ap.add_argument("--config", required=True, help="FoldConfig kwargs JSON")
    ap.add_argument("--nchan-shards", type=int, default=1)
    ap.add_argument("--out", required=True, help="npz written by process 0")
    ap.add_argument("--max-superblocks", type=int, default=0)
    args = ap.parse_args(argv)

    if args.devices_per_proc:
        flags = os.environ.get("XLA_FLAGS", "")
        flags = " ".join(f for f in flags.split()
                         if "host_platform_device_count" not in f)
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.devices_per_proc}")
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id)

    from ..io.sources import open_source
    from ..models.load_to_fold import FoldConfig
    from .pipeline import ShardedFoldPipeline
    from .sharded import make_mesh

    src = open_source(args.data)
    cfg = FoldConfig(**json.loads(args.config))
    mesh = make_mesh(len(jax.devices()), args.nchan_shards)
    pipe = ShardedFoldPipeline(src, cfg, mesh, distributed=True)
    res = pipe.run(max_superblocks=args.max_superblocks or None)

    if jax.process_index() == 0:
        np.savez(
            args.out,
            profiles=res.profiles,
            hits=res.hits,
            integration_length=res.integration_length,
            epochs_days=np.array([e.days for e in res.epochs], np.int64),
            epochs_frac=np.array([e.fracday() for e in res.epochs]),
            nbin=res.nbin,
            folding_period=res.folding_period,
            dispersion_measure=res.dispersion_measure,
            digitizer_counts=(res.digitizer_counts
                              if res.digitizer_counts is not None
                              else np.zeros(0, np.int64)),
        )
    # ordered shutdown: all processes reach here before teardown
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("dspsr_jax_worker_done")
    return 0


def launch_fold(data_path: str, config_kwargs: dict, n_procs: int = 2,
                devices_per_proc: int = 4, nchan_shards: int = 1,
                out_path: Optional[str] = None,
                max_superblocks: Optional[int] = None,
                timeout: float = 600.0):
    """Spawn ``n_procs`` local worker processes over a
    ``n_procs * devices_per_proc``-device mesh; returns the loaded npz of
    the combined result (process 0's output).

    ``devices_per_proc=0`` runs on real devices: worker ``i`` sees only
    GPU ``i`` (``CUDA_VISIBLE_DEVICES``), since a JAX process reserves
    most of a card's memory and two cannot share one."""
    if out_path is None:
        out_path = tempfile.mktemp(suffix=".npz", prefix="dspsr_mp_")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(n_procs):
        cmd = [sys.executable, "-m", "dspsr_jax.parallel.multiproc",
               "--coordinator", coord,
               "--num-processes", str(n_procs),
               "--process-id", str(pid),
               "--devices-per-proc", str(devices_per_proc),
               "--data", data_path,
               "--config", json.dumps(config_kwargs),
               "--nchan-shards", str(nchan_shards),
               "--out", out_path,
               "--max-superblocks", str(max_superblocks or 0)]
        penv = dict(env)
        if not devices_per_proc:
            penv["CUDA_VISIBLE_DEVICES"] = str(pid)
        procs.append(subprocess.Popen(cmd, env=penv))
    rcs = [p.wait(timeout=timeout) for p in procs]
    if any(rcs):
        raise RuntimeError(f"worker exit codes: {rcs}")
    return np.load(out_path)


if __name__ == "__main__":
    raise SystemExit(worker_main())
