"""Search-mode pipeline: load -> unpack -> filterbank -> detect -> scrunch ->
rescale -> requantize -> SIGPROC output.

Equivalent of the reference ``dsp::LoadToFil``
(``Signal/General/LoadToFil.C:135-374``; the ``digifil`` app): converts raw
baseband into a detected, levelled, n-bit filterbank stream.

Pipeline order mirrors the reference: [PolnSelect] -> Filterbank (coherent
chirp optional: ``-D`` dedispersing filterbank) -> Detection -> FScrunch ->
TScrunch -> Rescale -> [PScrunch] -> Digitizer -> OutputFile.

The whole per-block compute chain is one jitted device step returning packed
output bytes; the host loop streams blocks in and bytes out.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..observation import Observation, Signal
from ..io.sources import Source, open_source
from ..io.sigproc import SigProcWriter
from ..unpack.unpackers import UnpackPlan
from ..ops.response import Response, choose_nfft
from ..ops.dedispersion import Dedispersion
from ..ops.filterbank import FilterbankPlan, filterbank_block, update_observation
from ..ops.detection import detect
from ..ops.scrunch import (
    tscrunch, fscrunch, pscrunch_state,
    update_observation_tscrunch, update_observation_fscrunch,
)
from ..ops.rescale import RescaleState, rescale_block


@dataclass
class FilConfig:
    """Subset of digifil's options (``Signal/General/digifil.C``)."""

    nchan: int = 128  # -F
    frequency_resolution: Optional[int] = None  # -x
    dispersion_measure: float = 0.0  # -D (coherent dedispersing filterbank)
    tscrunch_factor: int = 1  # -t
    fscrunch_factor: int = 1  # -f
    npol_out: int = 1  # -d
    nbits: int = 8  # -b output bits
    twos_complement: bool = False  # input code convention (BitTable)
    #: 2-bit: JA98 dynamic levels + excision (TwoBitCorrection) vs the
    #: plain fixed BitTable map (BitUnpacker)
    dynamic_twobit: bool = True
    #: -I: seconds between rescale offset/scale updates; 0 = every block
    #: (cumulative running stats).  Scales hold constant between updates
    #: (reference Rescale interval semantics, Signal/General/Rescale.C)
    rescale_seconds: float = 0.0
    rescale_constant: bool = False  # -c freeze after first block
    #: -s: extra data scale factor applied before requantization
    #: (reference digifil -s -> Digitizer scale)
    scale_factor: float = 1.0
    #: select a single input polarization before the filterbank
    #: (reference PolnSelect, LoadToFil.C:162-180)
    poln_select: Optional[int] = None
    #: remove inter-channel dispersion delays (-K SampleDelay) fused into
    #: the chirp as per-channel phase ramps (DedispersionSampleDelay)
    interchannel_align: bool = False
    #: weights from the unpacker (2-bit excision) zero bad stretches before
    #: rescale/requantize (reference WeightedTimeSeries threading)
    apply_weights: bool = True
    #: channelizer: "fft" (dsp::Filterbank) or "polyphase"
    #: (dsp::PolyPhaseFilterbank; incoherent only)
    channelizer: str = "fft"
    pfb_ntaps: int = 8
    block_parts: int = 4
    #: minimum input samples per device block: raises the window count so
    #: tiny FFTs (e.g. freq_res=1) still amortize dispatch overhead
    #: (the reference sizes blocks from a RAM budget instead,
    #: IOManager::set_block_size, LoadToFold1.C:825-879)
    min_block_samples: int = 1 << 20

    # output digitizer levels: mean at digi_mean, sigma at digi_scale counts
    # (reference SigProcDigitizer uses DIGI_MEAN/DIGI_SIGMA)
    def digi_params(self):
        if self.nbits == 8:
            return 127.5, 32.0  # mean, counts/sigma
        if self.nbits == 4:
            return 7.5, 2.0
        if self.nbits == 2:
            return 1.5, 1.0
        if self.nbits == 1:
            return 0.5, 0.5
        if self.nbits == 32:
            return 0.0, 1.0  # float passthrough
        raise ValueError(f"unsupported output nbits={self.nbits}")

    def detection_state(self) -> Signal:
        return {1: Signal.INTENSITY, 2: Signal.PPQQ, 4: Signal.COHERENCE}[self.npol_out]


@partial(jax.jit, static_argnames=("nbits",))
def digitize(y: jnp.ndarray, nbits: int, mean: float, scale: float) -> jnp.ndarray:
    """Requantize float samples to n-bit offset-binary bytes in TFP order
    (reference ``SigProcDigitizer::pack``).

    y: float32[nchan, npol, ndat] already rescaled to ~N(0,1).
    Returns uint8[packed bytes] (time-major, pol, then channel — SIGPROC
    sample order).
    """
    nchan, npol, ndat = y.shape
    # TFP: [ndat, npol, nchan] (SIGPROC: channel fastest)
    t = jnp.transpose(y, (2, 1, 0))
    if nbits == 32:
        return jax.lax.bitcast_convert_type(
            t.astype(jnp.float32), jnp.uint8).reshape(-1)
    q = jnp.round(t * scale + mean)
    q = jnp.clip(q, 0, (1 << nbits) - 1).astype(jnp.uint32)
    flat = q.reshape(-1)
    if nbits == 8:
        return flat.astype(jnp.uint8)
    per = 8 // nbits
    g = flat.reshape(-1, per)
    # MSB first within each byte
    shifts = jnp.arange(per - 1, -1, -1, dtype=jnp.uint32) * nbits
    return jnp.sum(g << shifts[None, :], axis=1).astype(jnp.uint8)


class FilPipeline:
    """Constructed search-mode pipeline over one Source."""

    def __init__(self, source: Source, config: FilConfig):
        self.source = source
        self.config = config
        self.obs_in = source.obs
        self._construct()

    def _construct(self):
        cfg = self.config
        obs = self.obs_in
        real_input = obs.state == Signal.NYQUIST

        self.unpack_plan = UnpackPlan(
            obs, twos_complement=cfg.twos_complement,
            dynamic_twobit=cfg.dynamic_twobit)
        if cfg.poln_select is not None and not 0 <= cfg.poln_select < obs.npol:
            raise ValueError(f"poln_select={cfg.poln_select} out of range")
        self.npol_stream = 1 if cfg.poln_select is not None else obs.npol
        self.nchan_subband = max(1, cfg.nchan // obs.nchan)
        nchan_out = obs.nchan * self.nchan_subband

        if cfg.dispersion_measure > 0:
            nfp = Dedispersion._half_smearing_samples(
                cfg.dispersion_measure, obs.centre_frequency, obs.bandwidth,
                nchan_out, +1, 0.1)
            nfn = Dedispersion._half_smearing_samples(
                cfg.dispersion_measure, obs.centre_frequency, obs.bandwidth,
                nchan_out, -1, 0.1)
        else:
            nfp = nfn = 0
        nfilt = nfp + nfn

        if cfg.channelizer == "polyphase":
            if cfg.dispersion_measure > 0:
                raise ValueError(
                    "polyphase channelizer is incoherent; use the FFT "
                    "filterbank for coherent dedispersion (-D)")
            from ..ops.polyphase import PolyphasePlan, prototype_lowpass

            self.pfb_plan = PolyphasePlan(
                real_input=real_input, nchan_subband=self.nchan_subband,
                ntaps=cfg.pfb_ntaps)
            self._pfb_h = jnp.asarray(
                prototype_lowpass(self.nchan_subband, cfg.pfb_ntaps))
            self.fb_plan = None
        else:
            self.pfb_plan = None
            if cfg.frequency_resolution:
                freq_res = cfg.frequency_resolution
            elif nfilt == 0:
                freq_res = 1
            else:
                freq_res = choose_nfft(nfilt)
            self.fb_plan = FilterbankPlan(
                real_input=real_input, nchan_subband=self.nchan_subband,
                freq_res=freq_res, nfilt_pos=nfp, nfilt_neg=nfn)
            self.fb_plan.validate()

        if cfg.dispersion_measure > 0:
            from ..ops import sc

            builder = (Dedispersion.build_interchannel_aligned
                       if cfg.interchannel_align else Dedispersion.build)
            ded = builder(
                cfg.dispersion_measure, obs.centre_frequency, obs.bandwidth,
                nchan_out, freq_res)
            if cfg.interchannel_align:
                # the delay ramps need extra overlap cover
                self.fb_plan = FilterbankPlan(
                    real_input=real_input, nchan_subband=self.nchan_subband,
                    freq_res=freq_res, nfilt_pos=ded.impulse_pos,
                    nfilt_neg=ded.impulse_neg)
                self.fb_plan.validate()
            rr, ri = sc.from_numpy(ded.phasors)
            self._response_natural = (jnp.asarray(rr), jnp.asarray(ri))
        else:
            if cfg.interchannel_align:
                raise ValueError("-K needs a dispersion measure")
            self._response_natural = None

        if cfg.poln_select is not None and cfg.npol_out != 1:
            raise ValueError("poln_select implies npol_out=1")
        self.det_state = cfg.detection_state()
        if self.pfb_plan is not None:
            obs_s = obs.replace(
                nchan=obs.nchan * self.nchan_subband, ndim=2,
                state=Signal.ANALYTIC,
                rate=obs.rate / self.pfb_plan.step / (2 if real_input else 1)
                * (2 if real_input else 1) / 1,
            )
            obs_s = obs_s.replace(rate=obs.rate / self.pfb_plan.step)
        else:
            obs_s = update_observation(obs, self.fb_plan)
        obs_s = obs_s.replace(npol=self.npol_stream)
        obs_d = obs_s.apply_detection(self.det_state)
        obs_d = update_observation_fscrunch(obs_d, cfg.fscrunch_factor)
        obs_d = update_observation_tscrunch(obs_d, cfg.tscrunch_factor)
        if cfg.npol_out > 1:
            pass
        self.obs_out = obs_d.replace(nbit=cfg.nbits)

        geom = self.pfb_plan if self.pfb_plan is not None else self.fb_plan
        step = geom.step if self.pfb_plan is not None else geom.nsamp_step
        want = -(-cfg.min_block_samples // step)
        cap = geom.npart(self.source.total_samples)
        self.npart = min(max(want, cfg.block_parts), cap) if cap > 0 \
            else cfg.block_parts
        self.block_in_samples = geom.block_ndat(self.npart)
        self.stride_in_samples = self.npart * step
        self._rescale_state = RescaleState.zeros(
            self.obs_out.nchan, self.obs_out.npol)
        self._mean = jnp.zeros((self.obs_out.nchan, self.obs_out.npol),
                               jnp.float32)
        self._inv = jnp.ones((self.obs_out.nchan, self.obs_out.npol),
                             jnp.float32)
        self._blocks_done = 0
        self._since_update = 0

    def _stream_weights(self, w, nuse):
        """Unpacker block weights -> per-output-sample weights after the
        filterbank and scrunches (conservative min; see
        FoldPipeline._stream_weights)."""
        if w is None:
            return None
        cfg = self.config
        nchan_in, nweights = w.shape
        npw = self.unpack_plan.ndat_per_weight
        geom = self.pfb_plan if self.pfb_plan is not None else self.fb_plan
        step = geom.step if self.pfb_plan is not None else geom.nsamp_step
        nfft = (geom.window_samples if self.pfb_plan is not None
                else geom.nsamp_fft)
        nkeep = 1 if self.pfb_plan is not None else geom.nkeep
        if nweights == 0:
            return None
        per_win = []
        for p in range(self.npart):
            a = min((p * step) // npw, nweights - 1)
            b = max(min((p * step + nfft + npw - 1) // npw, nweights), a + 1)
            per_win.append(jnp.min(w[:, a:b], axis=1))
        wwin = jnp.stack(per_win, axis=1)  # [nchan_in, npart]
        ex = jnp.broadcast_to(wwin[:, :, None],
                              (nchan_in, self.npart, nkeep))
        ex = ex.reshape(nchan_in, self.npart * nkeep)
        # broadcast to output channels (pre-fscrunch)
        nchan_fb = nchan_in * self.nchan_subband
        ex = jnp.broadcast_to(ex[:, None, :],
                              (nchan_in, self.nchan_subband, ex.shape[-1]))
        ex = ex.reshape(nchan_fb, ex.shape[-1])
        # scrunches: a scrunched sample is bad if ANY contributor was bad
        f = cfg.fscrunch_factor
        if f > 1:
            ex = jnp.min(ex.reshape(nchan_fb // f, f, ex.shape[-1]), axis=1)
        t = cfg.tscrunch_factor
        if t > 1:
            n = (ex.shape[-1] // t) * t
            ex = jnp.min(ex[:, :n].reshape(ex.shape[0], n // t, t), axis=2)
        return ex[:, :nuse]

    @partial(jax.jit, static_argnames=("self", "mode"))
    def _step(self, rescale_state, mean, inv, raw, mode="cumulative"):
        """One block: unpack -> [PolnSelect] -> filterbank -> detect ->
        scrunch -> [weights] -> rescale -> digitize.

        mode selects the Rescale update semantics
        (``Signal/General/Rescale.C``):
          cumulative  accumulate + use running stats (every-block update)
          hold        frozen stats: use the passed mean/inv unchanged
          acc_hold    accumulate for the next interval, apply passed scales
          acc_update  interval boundary: accumulate, derive new scales,
                      reset the accumulator
        """
        from ..ops.rescale import accumulate, apply_scales, state_mean_scale

        x, w = self.unpack_plan.unpack(raw)
        if self.config.poln_select is not None:
            p = self.config.poln_select
            if isinstance(x, tuple):
                x = (x[0][:, p : p + 1], x[1][:, p : p + 1])
            else:
                x = x[:, p : p + 1]
        if self.pfb_plan is not None:
            from ..ops.polyphase import polyphase_filterbank_block

            y = polyphase_filterbank_block(x, self._pfb_h, self.pfb_plan,
                                           self.npart)
        else:
            y = filterbank_block(x, self.fb_plan, self.npart,
                                 self._response_natural)
        d = detect(y, self.det_state)
        d = fscrunch(d, self.config.fscrunch_factor)
        d = tscrunch(d, self.config.tscrunch_factor)
        weights = (self._stream_weights(w, d.shape[-1])
                   if self.config.apply_weights else None)
        if mode == "cumulative":
            rescale_state = accumulate(rescale_state, d, weights)
            mean, inv = state_mean_scale(rescale_state)
        elif mode == "acc_hold":
            rescale_state = accumulate(rescale_state, d, weights)
        elif mode == "acc_update":
            rescale_state = accumulate(rescale_state, d, weights)
            mean, inv = state_mean_scale(rescale_state)
            rescale_state = RescaleState.zeros(*rescale_state.count.shape)
        z = apply_scales(d, mean, inv, weights)
        dmean, dscale = self.config.digi_params()
        packed = digitize(z, self.config.nbits, dmean,
                          dscale * self.config.scale_factor)
        return rescale_state, mean, inv, packed

    def run(self, output_path: str, max_blocks: Optional[int] = None,
            total_seconds: Optional[float] = None,
            format: str = "sigproc") -> Observation:
        """Stream the whole source into a SIGPROC (.fil) or PSRFITS (.sf)
        search-mode file (digifil / digifits respectively)."""
        if format == "sigproc":
            writer = SigProcWriter(output_path, self.obs_out, self.config.nbits)
        elif format == "psrfits":
            from ..io.psrfits import PsrfitsSearchWriter

            writer = PsrfitsSearchWriter(output_path, self.obs_out,
                                         self.config.nbits)
        else:
            raise ValueError(f"unknown search output format {format!r}")
        with writer as out:
            self.run_writer(out, max_blocks=max_blocks,
                            total_seconds=total_seconds)
        return self.obs_out

    def run_writer(self, out, max_blocks: Optional[int] = None,
                   total_seconds: Optional[float] = None) -> None:
        """Stream blocks through the device step into any block writer."""
        src = self.source
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total, int(total_seconds * self.obs_in.rate))
        cfg = self.config

        start = 0
        nblocks = 0
        out_per_block = None
        interval_out = (int(cfg.rescale_seconds * self.obs_out.rate)
                        if cfg.rescale_seconds > 0 else 0)
        while start + self.block_in_samples <= nsamp_total:
            raw = src.read_samples(start, self.block_in_samples)
            if self._blocks_done == 0:
                mode = "cumulative"  # bootstrap scales from the first block
            elif cfg.rescale_constant:
                mode = "hold"
            elif interval_out:
                self._since_update += out_per_block
                if self._since_update >= interval_out:
                    mode = "acc_update"
                    self._since_update = 0
                else:
                    mode = "acc_hold"
            else:
                mode = "cumulative"
            self._rescale_state, self._mean, self._inv, packed = self._step(
                self._rescale_state, self._mean, self._inv,
                jnp.asarray(raw), mode)
            arr = np.asarray(packed)
            if out_per_block is None:
                bits_per_samp = self.obs_out.nchan * self.obs_out.npol \
                    * cfg.nbits
                out_per_block = arr.size * 8 // max(bits_per_samp, 1)
            out.write_block(arr)
            start += self.stride_in_samples
            nblocks += 1
            self._blocks_done += 1
            if max_blocks is not None and nblocks >= max_blocks:
                break


def load_to_fil(path: str, output_path: str, config: FilConfig, **run_kw) -> Observation:
    src = open_source(path)
    return FilPipeline(src, config).run(output_path, **run_kw)


def load_to_fits(path: str, output_path: str, config: FilConfig, **run_kw) -> Observation:
    """digifits equivalent (reference ``Signal/General/digifits.C``)."""
    src = open_source(path)
    return FilPipeline(src, config).run(output_path, format="psrfits", **run_kw)
