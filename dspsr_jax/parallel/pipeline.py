"""End-to-end multi-device fold pipeline — the LoadToFoldN equivalent.

The reference scales the fold pipeline by cloning it across pthreads with a
shared Input, InputBuffering::Share overlap handoff, and UnloaderShare subint
reduction (``Signal/Pulsar/LoadToFoldN.C:64-160``,
``Signal/General/MultiThread.C:90-370``); across cluster nodes it scatters
raw blocks via MPIRoot (``Kernel/Classes/MPIRoot.C:318-472``).

Shape: ONE jitted step over a ``(time, chan)`` ``jax.sharding.Mesh`` per
*superblock*:

- the **time axis** plays the role of the thread pool: each time shard runs
  the full single-chip op chain (``FoldPipeline._step_core`` — the SAME code
  path, so 2-bit excision weights, SK, Jones, RFI zap and cyclic folding all
  work sharded) on its own contiguous stripe of raw bytes;
- the overlap-save halo is exchanged as **raw bytes between devices** with
  ``lax.ppermute`` (shard i's head bytes go to shard i-1, replacing
  InputBuffering::Share); the superblock's trailing halo rides in on a
  host-provided tail row for the last shard, so every window of every shard
  is valid — no masking, no re-reads;
- the **chan axis** is the MPITrans channel scatter: the slice happens
  between the big forward FFT and the per-subband inversion
  (``_step_core(chan_ix=..., n_chan_shards=...)``);
- fold accumulators reduce over time shards with ``psum``
  (``PhaseSeries::combine``) and stay chan-sharded across superblocks.

Hosts read **disjoint stripes** (superblock layout) — the MPIRoot scatter
without the root.  Subint division happens at superblock granularity
(matching the reference's block-granularity TimeDivide decisions when the
divisions align; see ``run``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..timing.mjd import MJD
from ..io.sources import Source
from ..models.load_to_fold import FoldConfig, FoldPipeline, FoldResult
from ..ops.fold import compute_anchors
from ..unpack.unpackers import state_counts_from_byte_counts
from .sharded import make_mesh


class ShardedFoldPipeline:
    """Streams a Source through superblocks on a (time, chan) mesh.

    Usage::

        mesh = make_mesh(8, nchan_shards=2)
        pipe = ShardedFoldPipeline(src, config, mesh)
        result = pipe.run()          # FoldResult, same as FoldPipeline.run()
    """

    def __init__(self, source: Source, config: FoldConfig, mesh: Mesh,
                 distributed: bool = False):
        """``distributed=True``: the mesh spans multiple jax processes
        (``jax.distributed.initialize`` must have run).  Each process then
        reads ONLY the stripes whose time shards it hosts — the disjoint
        multi-host striping that replaces the reference's MPIRoot raw-block
        scatter (``Kernel/Classes/MPIRoot.C:318-472``) — and global device
        arrays are assembled with ``jax.make_array_from_callback``."""
        if "time" not in mesh.shape or "chan" not in mesh.shape:
            raise ValueError("mesh needs ('time', 'chan') axes")
        self.mesh = mesh
        self.distributed = bool(distributed)
        self.n_time = mesh.shape["time"]
        self.n_chan = mesh.shape["chan"]
        # the inner single-shard pipeline: identical construction
        cfg = dataclasses.replace(config)
        # cap the per-shard block so at least one superblock fits the source
        avail = source.total_samples
        if avail < (1 << 60):
            cap = max(avail // (self.n_time + 1), 4096)
            cfg = dataclasses.replace(
                cfg, min_block_samples=min(cfg.min_block_samples, cap))
        if cfg.dump_path:
            raise NotImplementedError("dump tap not supported sharded")
        if cfg.additional_pulsars:
            raise NotImplementedError(
                "multi-pulsar folding not supported sharded: accumulators "
                "are 3-D per shard (use FoldPipeline for --pulsar)")
        if cfg.sk_also_unzapped:
            raise NotImplementedError(
                "-noskz_too not supported sharded (multi-accumulator fold;"
                " use FoldPipeline)")
        if cfg.passband:
            raise NotImplementedError(
                "passband integration not supported sharded "
                "(use FoldPipeline for --passband)")
        self.inner = FoldPipeline(source, cfg)
        self.config = cfg
        self.source = source

        inner = self.inner
        if inner.obs_out.nchan % self.n_chan:
            raise ValueError(
                f"nchan_out={inner.obs_out.nchan} not divisible by "
                f"chan shards={self.n_chan}")
        nlocal = inner.obs_out.nchan // self.n_chan
        nsub = inner.fb_plan.nchan_subband if inner.fb_plan is not None else 1
        if not (nlocal % nsub == 0 or nsub % nlocal == 0):
            raise ValueError("chan shard boundary must align with subband "
                             "groups of one input channel")

        bps = inner.obs_in.nbytes_per_sample
        self.stride_bytes = int(round(inner.stride_in_samples * bps))
        self.halo_bytes = int(round(inner.nsamp_overlap * bps))
        if abs(inner.stride_in_samples * bps - self.stride_bytes) > 1e-9 or \
           abs(inner.nsamp_overlap * bps - self.halo_bytes) > 1e-9:
            raise ValueError("shard stride/halo not byte-aligned")

        self.superblock_samples = (self.n_time * inner.stride_in_samples
                                   + inner.nsamp_overlap)
        self.superblock_stride = self.n_time * inner.stride_in_samples

        self._step = self._build_step()
        nchan, npol = inner.obs_out.nchan, inner.obs_out.npol
        self._profiles = self._commit(
            np.zeros((nchan, npol, inner.nbin), np.float32), P("chan"))
        self._hits = self._commit(
            np.zeros((nchan, inner.nbin), np.float32), P("chan"))
        self._subints = []
        self._current_div = 0
        self._div_samples = 0.0
        self._first_out_time: Optional[MJD] = None
        self._last_out_time: Optional[MJD] = None
        self._div_first_time: Optional[MJD] = None
        self._byte_counts = np.zeros(256, np.int64)

    # ---- the jitted superblock step ----

    def _build_step(self):
        inner = self.inner
        n_time, n_chan = self.n_time, self.n_chan
        halo_b = self.halo_bytes

        def local(profiles, hits, raw, tail, phi0, dphi, bounds):
            raw, tail = raw[0], tail[0]
            phi0, dphi = phi0[0], dphi[0]
            if halo_b:
                # InputBuffering::Share between devices: my head bytes are
                # my left neighbour's trailing halo
                head = raw[:halo_b]
                perm = [(i, (i - 1) % n_time) for i in range(n_time)]
                from_right = jax.lax.ppermute(head, "time", perm)
                ti = jax.lax.axis_index("time")
                halo = jnp.where(ti == n_time - 1, tail, from_right)
                raw = jnp.concatenate([raw, halo])
            # per-shard sample-exact fold span (TimeDivide bounds,
            # matching the single pipeline's mid-block splits): a shard
            # entirely outside the current division gets [0, 0) and
            # contributes zero; a boundary shard folds exactly its
            # division's samples
            ci = jax.lax.axis_index("chan")
            dprof, dhits = inner._step_core(
                jnp.zeros_like(profiles), jnp.zeros_like(hits), raw,
                phi0, dphi, chan_ix=ci, n_chan_shards=n_chan,
                bounds=bounds[0])
            # PhaseSeries::combine across the time shards
            dprof = jax.lax.psum(dprof, "time")
            dhits = jax.lax.psum(dhits, "time")
            return profiles + dprof, hits + dhits

        sm = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P("chan"), P("chan"), P("time"), P("time"),
                      P("time"), P("time"), P("time")),
            out_specs=(P("chan"), P("chan")),
            check_vma=False,
        )
        return jax.jit(sm, donate_argnums=(0, 1))

    # ---- distributed-array plumbing (multi-process meshes) ----

    def _commit(self, np_arr: np.ndarray, spec: P):
        """Host array -> device array committed to the mesh sharding.

        Single-process: a plain transfer.  Multi-process: a global array
        assembled from each process's addressable shards
        (``jax.make_array_from_callback`` only invokes the callback for
        local shards, so non-local data is never touched)."""
        if not self.distributed:
            return jnp.asarray(np_arr)
        from jax.sharding import NamedSharding

        return jax.make_array_from_callback(
            np_arr.shape, NamedSharding(self.mesh, spec),
            lambda idx: np.ascontiguousarray(np_arr[idx]))

    def _fetch(self, arr) -> np.ndarray:
        """Device array -> host numpy on EVERY process (allgather when the
        mesh spans processes and the array is not fully replicated)."""
        if not self.distributed or arr.is_fully_replicated:
            return np.asarray(arr)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))

    def local_time_shards(self) -> list:
        """Time-shard indices whose devices this process hosts (in the
        single-process case: all of them)."""
        me = jax.process_index()
        return [t for t in range(self.n_time)
                if any(d.process_index == me for d in self.mesh.devices[t])]

    # ---- host streaming loop ----

    def host_stripe_layout(self, sb_start: int):
        """(start_sample, nsamples) read per time shard for the superblock at
        ``sb_start`` — disjoint ranges plus one trailing halo read (the
        multi-host striping contract replacing MPIRoot)."""
        s = self.inner.stride_in_samples
        stripes = [(sb_start + i * s, s) for i in range(self.n_time)]
        tail = (sb_start + self.n_time * s, self.inner.nsamp_overlap)
        return stripes, tail

    def _read_superblock(self, sb_start: int):
        """Read this superblock's stripes.  In distributed mode only the
        stripes hosted by THIS process touch the disk (disjoint multi-host
        striping, the MPIRoot-scatter replacement); remote rows stay zero
        and are never shipped (``_commit`` reads local shards only)."""
        src = self.source
        stripes, tail = self.host_stripe_layout(sb_start)
        local = set(self.local_time_shards()) if self.distributed \
            else set(range(self.n_time))
        rows = np.zeros((self.n_time, self.stride_bytes), np.uint8)
        for i, (s, n) in enumerate(stripes):
            if i in local:
                rows[i] = src.read_samples(s, n)
        tail_rows = np.zeros((self.n_time, self.halo_bytes), np.uint8)
        if self.halo_bytes and (self.n_time - 1) in local:
            tail_rows[-1] = src.read_samples(*tail)
        return rows, tail_rows

    def _flush_division(self):
        if self._div_samples == 0:
            return
        prof = self._fetch(self._profiles)
        hits = self._fetch(self._hits)
        self._subints.append(
            (prof, hits, self._div_first_time or self._first_out_time,
             self._div_samples / self.inner.obs_out.rate))
        self._div_first_time = None
        self._profiles = jnp.zeros_like(self._profiles)
        self._hits = jnp.zeros_like(self._hits)
        self._div_samples = 0.0

    def run(self, max_superblocks: Optional[int] = None,
            total_seconds: Optional[float] = None) -> FoldResult:
        inner = self.inner
        cfg = self.config
        src = self.source
        seek = int(cfg.seek_seconds * inner.obs_in.rate) if cfg.seek_seconds else 0
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total,
                              seek + int(total_seconds * inner.obs_in.rate))

        tsamp_out = 1.0 / inner.obs_out.rate
        seg = inner.fold_plan.seg_len
        # anchors cover the padded tail segment; folded samples per shard
        # are exactly out_per_block
        nuse_pad = -(-inner.out_per_block // seg) * seg
        nuse = inner.out_per_block
        nseg = nuse_pad // seg

        # SAMPLE-EXACT sub-integration divider (TimeDivide/SubFold): a
        # -L/--turns boundary may land mid-shard, in which case the
        # superblock is folded once per division with per-shard
        # [lo, hi) bounds — identical semantics to the single pipeline's
        # mid-block splits (Signal/Pulsar/TimeDivide.C:132-257)
        divider = None
        if cfg.subint_seconds > 0 or cfg.subint_turns > 0:
            from ..timing.timedivide import TimeDivide

            lep = cfg.integration_reference_epoch
            divider = TimeDivide(
                rate=inner.obs_out.rate,
                start_time=inner.output_start_time(seek),
                seconds=cfg.subint_seconds, turns=cfg.subint_turns,
                predictor=inner.predictor,
                reference_phase=cfg.reference_phase,
                reference_epoch=(MJD.from_mjd(lep) if lep else None),
                fractional_pulses=cfg.fractional_pulses)

        out_off = 0
        start = seek
        nsb = 0
        while start + self.superblock_samples <= nsamp_total:
            t0s = [inner.output_start_time(start + i * inner.stride_in_samples)
                   for i in range(self.n_time)]
            if self._first_out_time is None:
                self._first_out_time = t0s[0]

            rows, tail_rows = self._read_superblock(start)
            if cfg.digitizer_stats and inner.obs_in.nbit <= 8:
                # count per-shard stride + halo, matching the single-pipeline
                # semantics where overlap bytes are re-unpacked per block.
                # Distributed: each process counts its local stripes; the
                # totals are summed across processes at finish.  A stripe's
                # halo comes from the NEXT stripe's head, which may live on
                # another process — count it there instead (same total).
                local = set(self.local_time_shards()) if self.distributed \
                    else set(range(self.n_time))
                for i in local:
                    self._byte_counts += np.bincount(rows[i].ravel(),
                                                     minlength=256)
                for i in range(self.n_time):
                    if not self.halo_bytes:
                        continue
                    if i == self.n_time - 1:
                        if i in local:
                            self._byte_counts += np.bincount(
                                tail_rows[-1].ravel(), minlength=256)
                    elif (i + 1) in local:
                        self._byte_counts += np.bincount(
                            rows[i + 1][: self.halo_bytes], minlength=256)
            phi0 = np.empty((self.n_time, nseg), np.float32)
            dphi = np.empty((self.n_time, nseg), np.float32)
            for i, t0 in enumerate(t0s):
                p0, dp = compute_anchors(inner.predictor, t0, tsamp_out,
                                         nuse_pad, seg)
                phi0[i] = (p0 - cfg.reference_phase) % 1.0
                dphi[i] = dp

            rows_d = self._commit(rows, P("time"))
            tail_d = self._commit(tail_rows, P("time"))
            phi0_d = self._commit(phi0, P("time"))
            dphi_d = self._commit(dphi, P("time"))
            # fold once per division present in this superblock (one
            # dispatch in the common boundary-free case), each shard
            # bounded to exactly its division's samples
            if divider is None:
                passes = [(0, None)]
            else:
                shard_segs = [divider.segments(out_off + i * nuse, nuse)
                              for i in range(self.n_time)]
                present = sorted({dv for segs in shard_segs
                                  for (_, _, dv) in segs if dv >= 0})
                passes = [(v, shard_segs) for v in present]
            for v, segs in passes:
                if segs is None:
                    bounds = np.broadcast_to(
                        np.array([0, nuse], np.int32),
                        (self.n_time, 2)).copy()
                    nfold = nuse * self.n_time
                else:
                    bounds = np.zeros((self.n_time, 2), np.int32)
                    nfold = 0
                    first_sample = None
                    for i, ss in enumerate(segs):
                        for (lo, hi, dv) in ss:
                            if dv == v:
                                bounds[i] = (lo, hi)
                                nfold += hi - lo
                                if first_sample is None:
                                    first_sample = out_off + i * nuse + lo
                    if v != self._current_div:
                        self._flush_division()
                        self._current_div = v
                    if self._div_first_time is None:
                        self._div_first_time = divider.epoch_of(first_sample)
                self._profiles, self._hits = self._step(
                    self._profiles, self._hits, rows_d, tail_d, phi0_d,
                    dphi_d, self._commit(bounds, P("time")))
                if segs is None and self._div_first_time is None:
                    self._div_first_time = t0s[0]
                self._div_samples += nfold

            self._last_out_time = t0s[-1] + nuse * tsamp_out
            out_off += nuse * self.n_time
            start += self.superblock_stride
            nsb += 1
            if max_superblocks is not None and nsb >= max_superblocks:
                break

        self._flush_division()
        return self._finish()

    def _finish(self) -> FoldResult:
        inner = self.inner
        if self.config.minimum_integration_length > 0:
            self._subints = [
                s for s in self._subints
                if s[3] >= self.config.minimum_integration_length]
        # NOTE: collectives must run on EVERY process (process-independent
        # condition), so gate on config only — never on local data
        if self.distributed and self.config.digitizer_stats \
                and inner.obs_in.nbit <= 8:
            # each process counted only its local stripes: sum them
            from jax.experimental import multihost_utils

            stacked = multihost_utils.process_allgather(
                self._byte_counts, tiled=False)
            self._byte_counts = np.asarray(stacked).reshape(
                -1, 256).sum(axis=0)
        if self._subints:
            profs = np.stack([s[0] for s in self._subints])
            hits = np.stack([s[1] for s in self._subints])
        else:
            profs = np.zeros((0, inner.obs_out.nchan, inner.obs_out.npol,
                              inner.nbin))
            hits = np.zeros((0, inner.obs_out.nchan, inner.nbin))
        return FoldResult(
            profiles=profs,
            hits=hits,
            epochs=[s[2] for s in self._subints],
            integration_length=np.array([s[3] for s in self._subints]),
            obs=inner.obs_out,
            nbin=inner.nbin,
            folding_period=inner.folding_period,
            dispersion_measure=inner.dm,
            cyclic_nlag=(inner.cyclic_plan.nlag if inner.cyclic_plan else 0),
            cyclic_mover=(inner.cyclic_plan.mover if inner.cyclic_plan else 1),
            cyclic_npol=(inner.obs_stream.npol if inner.cyclic_plan else 1),
            signal_path=inner.signal_path() + [
                {"op": "ShardedRun", "n_time": self.n_time,
                 "n_chan": self.n_chan}],
            digitizer_counts=(
                state_counts_from_byte_counts(self._byte_counts,
                                              inner.obs_in.nbit)
                if self.config.digitizer_stats and inner.obs_in.nbit <= 8
                and self._byte_counts.any() else None),
        )


def load_to_fold_sharded(path: str, config: FoldConfig,
                         n_devices: Optional[int] = None,
                         nchan_shards: int = 1, **run_kw) -> FoldResult:
    """One-call convenience (the dspsr -t N equivalent)."""
    from ..io.sources import open_source

    src = open_source(path)
    mesh = make_mesh(n_devices, nchan_shards)
    return ShardedFoldPipeline(src, config, mesh).run(**run_kw)
