"""Multi-device search-mode pipeline — LoadToFilN / LoadToFITSN equivalent.

The reference scales digifil/digifits by cloning the pipeline across
threads and serializing the packed output through ``OutputFileShare``
(``Signal/General/LoadToFilN.C``, ``Kernel/Classes/OutputFileShare.C``).

Shape, mirroring :class:`parallel.pipeline.ShardedFoldPipeline`:
one jitted step per superblock over the mesh's ``time`` axis — each shard
runs the single-chip :meth:`FilPipeline` op chain (unpack, PolnSelect,
filterbank/chirp, detection, scrunches, weights, rescale, digitize) on its
stripe with the overlap-save halo exchanged as raw bytes between devices
(``lax.ppermute``); packed
rows come back per shard and the host writes them **in time order** (the
OutputFileShare role — trivially ordered since the superblock step is
synchronous).

Rescale semantics across shards: scales are bootstrapped from the FIRST
shard's first-block statistics (bit-matching the single pipeline's first
block) and then either held constant (``rescale_constant``, exact parity
with the single run) or refreshed every ``rescale_seconds`` from the
psum-combined statistics of all shards (documented superblock-granular
variant of -I).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..io.sources import Source
from ..models.load_to_fil import FilConfig, FilPipeline, digitize
from ..ops.rescale import RescaleState, accumulate, apply_scales, state_mean_scale


class ShardedFilPipeline:
    """Streams a Source through search-mode superblocks on the mesh."""

    def __init__(self, source: Source, config: FilConfig, mesh: Mesh):
        if "time" not in mesh.shape:
            raise ValueError("mesh needs a 'time' axis")
        if mesh.shape.get("chan", 1) != 1:
            raise NotImplementedError(
                "search-mode chan sharding not implemented (output rows "
                "need all channels; use time shards)")
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        # cap the per-shard block so at least one superblock fits the source
        avail = source.total_samples
        if avail < (1 << 60):
            cap = max(avail // (self.n_time + 1), 4096)
            config = dataclasses.replace(
                config, min_block_samples=min(config.min_block_samples, cap))
        self.inner = FilPipeline(source, config)
        self.config = config
        self.source = source

        inner = self.inner
        geom = inner.pfb_plan if inner.pfb_plan is not None else inner.fb_plan
        step = geom.step if inner.pfb_plan is not None else geom.nsamp_step
        overlap = inner.block_in_samples - inner.stride_in_samples
        bps = inner.obs_in.nbytes_per_sample
        self.stride_bytes = int(round(inner.stride_in_samples * bps))
        self.halo_bytes = int(round(overlap * bps))
        self.nsamp_overlap = overlap
        self.superblock_samples = (self.n_time * inner.stride_in_samples
                                   + overlap)
        self.superblock_stride = self.n_time * inner.stride_in_samples
        self._step = self._build_step()
        self._state = RescaleState.zeros(inner.obs_out.nchan,
                                         inner.obs_out.npol)
        self._mean = None
        self._inv = None
        self._out_since_update = 0

    def _local_chain(self, raw):
        """The single-chip op chain up to (detected, scrunched, weighted)."""
        inner = self.inner
        cfg = self.config
        from ..ops.detection import detect
        from ..ops.scrunch import tscrunch, fscrunch
        from ..ops.filterbank import filterbank_block

        x, w = inner.unpack_plan.unpack(raw)
        if cfg.poln_select is not None:
            p = cfg.poln_select
            if isinstance(x, tuple):
                x = (x[0][:, p : p + 1], x[1][:, p : p + 1])
            else:
                x = x[:, p : p + 1]
        if inner.pfb_plan is not None:
            from ..ops.polyphase import polyphase_filterbank_block

            y = polyphase_filterbank_block(x, inner._pfb_h, inner.pfb_plan,
                                           inner.npart)
        else:
            y = filterbank_block(x, inner.fb_plan, inner.npart,
                                 inner._response_natural)
        d = detect(y, inner.det_state)
        d = fscrunch(d, cfg.fscrunch_factor)
        d = tscrunch(d, cfg.tscrunch_factor)
        weights = (inner._stream_weights(w, d.shape[-1])
                   if cfg.apply_weights else None)
        return d, weights

    def _build_step(self):
        inner = self.inner
        n_time = self.n_time
        halo_b = self.halo_bytes
        cfg = self.config

        def local(raw, tail, mean, inv):
            raw, tail = raw[0], tail[0]
            if halo_b:
                head = raw[:halo_b]
                perm = [(i, (i - 1) % n_time) for i in range(n_time)]
                from_right = jax.lax.ppermute(head, "time", perm)
                ti = jax.lax.axis_index("time")
                halo = jnp.where(ti == n_time - 1, tail, from_right)
                raw = jnp.concatenate([raw, halo])
            d, weights = self._local_chain(raw)
            # per-shard statistics (for updates) + shard-0-only stats (for
            # the single-pipeline-equivalent bootstrap)
            st = accumulate(RescaleState.zeros(d.shape[0], d.shape[1]),
                            d, weights)
            ti = jax.lax.axis_index("time")
            first = (ti == 0).astype(jnp.float32)
            st_all = jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, "time"), st)
            st_first = jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a * first, "time"), st)
            z = apply_scales(d, mean, inv, weights)
            dmean, dscale = cfg.digi_params()
            packed = digitize(z, cfg.nbits, dmean, dscale)
            return packed[None], st_all, st_first

        sm = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P("time"), P("time"), P(), P()),
            out_specs=(P("time"), P(), P()),
            check_vma=False,
        )
        return jax.jit(sm)

    def _read_superblock(self, sb_start: int):
        src = self.source
        s = self.inner.stride_in_samples
        rows = np.stack([src.read_samples(sb_start + i * s, s)
                         for i in range(self.n_time)])
        tail = np.zeros((self.n_time, self.halo_bytes), np.uint8)
        if self.halo_bytes:
            tail[-1] = src.read_samples(sb_start + self.n_time * s,
                                        self.nsamp_overlap)
        return rows, tail

    def run(self, output_path: str, max_superblocks: Optional[int] = None,
            format: str = "sigproc", total_seconds: Optional[float] = None):
        from ..io.sigproc import SigProcWriter

        inner = self.inner
        cfg = self.config
        if format == "sigproc":
            writer = SigProcWriter(output_path, inner.obs_out, cfg.nbits)
        elif format == "psrfits":
            from ..io.psrfits import PsrfitsSearchWriter

            writer = PsrfitsSearchWriter(output_path, inner.obs_out,
                                         cfg.nbits)
        else:
            raise ValueError(format)

        nsamp_total = self.source.total_samples
        if total_seconds is not None:
            # -T limit (reference SingleThread.C:694-719), clamped like
            # FilPipeline.run
            nsamp_total = min(nsamp_total,
                              int(total_seconds * inner.obs_in.rate))
        interval_out = (int(cfg.rescale_seconds * inner.obs_out.rate)
                        if cfg.rescale_seconds > 0 else 0)
        out_per_shard = None
        with writer as out:
            start = 0
            nsb = 0
            while start + self.superblock_samples <= nsamp_total:
                rows, tail = self._read_superblock(start)
                if self._mean is None:
                    # bootstrap: probe pass to get shard-0 statistics, then
                    # rescale this superblock with those scales (matching
                    # the single pipeline's first-block bootstrap)
                    nchan, npol = inner.obs_out.nchan, inner.obs_out.npol
                    zero_m = jnp.zeros((nchan, npol), jnp.float32)
                    one_i = jnp.ones((nchan, npol), jnp.float32)
                    _, _, st_first = self._step(jnp.asarray(rows),
                                                jnp.asarray(tail),
                                                zero_m, one_i)
                    self._mean, self._inv = state_mean_scale(
                        RescaleState(*st_first))
                    # _state stays zero: the real step below returns st_all
                    # (which already includes shard 0 of this superblock), so
                    # seeding st_first here would double-count shard 0 in the
                    # first -I interval update
                packed, st_all, _ = self._step(jnp.asarray(rows),
                                               jnp.asarray(tail),
                                               self._mean, self._inv)
                packed = np.asarray(packed)
                # OutputFileShare: rows written strictly in time order
                for i in range(self.n_time):
                    out.write_block(packed[i])
                if out_per_shard is None:
                    bits = inner.obs_out.nchan * inner.obs_out.npol * cfg.nbits
                    out_per_shard = packed[0].size * 8 // max(bits, 1)
                if interval_out and not cfg.rescale_constant:
                    self._state = jax.tree_util.tree_map(
                        lambda a, b: a + b, self._state, RescaleState(*st_all))
                    self._out_since_update += out_per_shard * self.n_time
                    if self._out_since_update >= interval_out:
                        self._mean, self._inv = state_mean_scale(self._state)
                        self._state = RescaleState.zeros(
                            inner.obs_out.nchan, inner.obs_out.npol)
                        self._out_since_update = 0
                start += self.superblock_stride
                nsb += 1
                if max_superblocks is not None and nsb >= max_superblocks:
                    break
        return inner.obs_out
