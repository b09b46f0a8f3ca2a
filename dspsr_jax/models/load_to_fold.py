"""Fold-mode pipeline: load -> unpack -> (filterbank|convolve) -> detect -> fold.

Equivalent of the reference ``dsp::LoadToFold``
(``Signal/Pulsar/LoadToFold1.C``): assembles the end-to-end fold pipeline
from a config, prepares chirps/plans/predictors, and runs the block loop.

The whole per-block pipeline is ONE jitted function (``FoldPipeline._step``)
with the fold accumulators as donated carry: XLA fuses the elementwise
stages of unpack, chirp multiply and detection around the FFTs and the fold
contraction in a single device program per block; the host loop just feeds
raw bytes and float32 phase anchors.  This replaces the reference's operation vector +
pthread pipeline replication (``SingleThread.C:405-430``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..observation import Observation, Signal
from ..timing.mjd import MJD
from ..timing.polyco import Polyco, FixedPeriodPredictor
from ..timing.par import Ephemeris
from ..io.sources import Source, open_source
from ..unpack.unpackers import UnpackPlan, state_counts_from_byte_counts
from ..ops import sc
from ..ops.response import Response, choose_nfft
from ..ops.dedispersion import Dedispersion
from ..ops import convolution
from ..ops.convolution import OverlapSavePlan
from ..ops.filterbank import FilterbankPlan, filterbank_block, update_observation
from ..ops.detection import detect
from ..ops.fold import FoldPlan, fold_block, compute_anchors, choose_nbin
from ..ops.spectral_kurtosis import SKPlan, sk_mask, expand_mask
from ..ops.detection import detect_intensity


@dataclass
class FoldConfig:
    """Subset of the reference ``LoadToFold::Config``
    (``Signal/Pulsar/LoadToFoldConfig.C``) — grows as features land."""

    # dispersion / channelization
    dispersion_measure: Optional[float] = None  # -D; default from ephemeris
    nchan: int = 1  # -F: output filterbank channels
    frequency_resolution: Optional[int] = None  # -x: spectral res per channel
    #: -x min / minXu: use u times the MINIMUM valid transform length
    #: (the smallest power of two exceeding the kernel length; reference
    #: times_minimum_nfft, dspsr.C:774-782)
    times_minimum_nfft: int = 0
    coherent: bool = True  # coherent dedispersion (chirp) vs none

    # folding
    nbin: int = 0  # -b; 0 = choose automatically
    folding_period: Optional[float] = None  # -c
    polyco_path: Optional[str] = None  # -P
    ephemeris_path: Optional[str] = None  # -E
    #: fold additional sources in the same pass: each entry a period (s),
    #: a polyco/T2 predictor path, or a .par path (reference multi-pulsar
    #: folding via ObservationChange + one Fold per source,
    #: LoadToFold1.C:1155-1242); results land in FoldResult.extra_sources
    additional_pulsars: tuple = ()
    #: Jones polarization calibration: solution file or cal database
    #: (reference PolnCalibration + matrix convolution)
    calibration_path: Optional[str] = None
    #: measure FFT costs on the backend and pick the cheapest length
    #: (reference --fft-bench -> OptimalFFT; default: analytic model)
    use_fft_bench: bool = False
    #: taper applied to each window before the forward FFT
    #: (--fft-window; reference Apodization inside Convolution,
    #: Convolution.C:379-387): none|hanning|welch|parzen|tukey
    fft_window: Optional[str] = None
    #: integrate the pre-detection bandpass during the run and attach it to
    #: the archive (reference Response/Passband integration ->
    #: Archiver Passband extension, Archiver.C:407-773)
    passband: bool = False
    #: -Y: accumulate pdmp extras — running moments S1..S4 of the detected
    #: stream per (chan, pol) (reference Stats op, Signal/General/Stats.C)
    pdmp_stats: bool = False
    reference_phase: float = 0.0  # -p
    #: reference epoch for phase zero when folding at a constant period
    #: (reference --cepoch; default: the observation start time): an MJD
    #: as float days or "MJD" string
    reference_epoch: Optional[float] = None

    # detection
    npol_out: int = 1  # -d 1|2|4 -> Intensity|PPQQ|Stokes
    #: explicit detection state overriding the npol_out mapping:
    #: intensity|ppqq|pp|qq|coherence|stokes (the reference folds 4-pol
    #: COHERENCE products and converts to Stokes at archive time,
    #: Detection.C:42-66 + Archiver; see FoldResult.to_stokes)
    detection: Optional[str] = None
    fourth_moment: bool = False  # -4: fold S_i*S_j moments too
    #: remove inter-channel dispersion delays inside the chirp (the -K
    #: SampleDelay op fused into the response as a phase ramp)
    interchannel_align: bool = False

    # cyclic spectroscopy (reference -cyclic N / CyclicFold)
    cyclic_nchan: int = 0  # cyclic channels per input channel (0 = off)
    cyclic_mover: int = 1  # oversampling factor

    # input windowing (reference -S; SingleThread.C:694-719)
    seek_seconds: float = 0.0

    # subints
    subint_seconds: float = 0.0  # -L
    subint_turns: int = 0  # --turns: divide by pulse turns (TimeDivide)
    #: discard subints shorter than this many seconds (reference -m ->
    #: PhaseSeriesUnloader::set_minimum_integration_length; typically drops
    #: the final partial subint)
    minimum_integration_length: float = 0.0
    #: explicit MJD of the first sub-integration boundary (reference
    #: -Lepoch -> TimeDivide reference_epoch); default: integer -L aligns
    #: to UTC multiples of the division length in the day
    #: (TimeDivide.C:60-81)
    integration_reference_epoch: Optional[float] = None
    #: -y: keep partially-completed integrations — for single-pulse/turn
    #: divisions, fold the partial first pulse instead of discarding data
    #: before the first reference-phase crossing (TimeDivide.C:122-129)
    fractional_pulses: bool = False

    # engine geometry
    block_parts: int = 4  # FFT windows per device block
    blocks_per_step: int = 1  # blocks folded per device dispatch (scan)
    #: minimum input samples per device block (amortizes dispatch overhead
    #: when the FFT windows are small; the reference sizes blocks from a RAM
    #: budget, IOManager::set_block_size, LoadToFold1.C:825-879)
    min_block_samples: int = 1 << 20
    seg_len: int = 2048  # fold phase-anchor segment (output samples)
    max_nfft: int = 1 << 24

    # observability (-r: per-stage timing report + progress meter)
    report: bool = False
    #: accumulate digitizer state histograms host-side and attach them to
    #: the archive (reference HistUnpacker -> TwoBitStats/DigitiserCounts
    #: extensions, Signal/Pulsar/ArchiverExtensions.C)
    digitizer_stats: bool = True
    #: write the detected (pre-fold) stream to a float32 DADA file that
    #: FloatUnpacker can re-ingest (reference Dump op, --dump;
    #: SingleThread.C:315-346 + Unpacker_registry.C:23-25)
    dump_path: Optional[str] = None

    # unpacking
    twos_complement: bool = False
    #: 2-bit: JA98 dynamic output levels + excision (TwoBitCorrection;
    #: the reference's 2-bit instruments); False = the plain fixed
    #: BitTable level map (BitUnpacker), no excision weights
    dynamic_twobit: bool = True
    ndat_per_weight: int = 512
    cutoff_sigma: float = 3.0

    # narrow-band RFI zapping from the median bandpass (reference RFIFilter)
    rfi_filter: bool = False
    rfi_median_width: int = 21
    rfi_threshold: float = 4.0

    # spectral kurtosis RFI excision (reference -skz / SKDetector config)
    sk_enable: bool = False
    sk_m: int = 128  # -skm: samples per SK cell
    sk_std_devs: int = 3  # -skn
    sk_no_tscr: bool = False  # --skz_no_tscr (SpectralKurtosis::set_options)
    sk_no_fscr: bool = False  # --skz_no_fscr
    sk_chan_start: int = 0  # --skz_start: first channel with signal
    sk_chan_end: int = 0  # --skz_end: last channel (exclusive; 0 = band end)
    #: -noskz_too: ALSO fold the un-zapped (pre-SK) stream and return it
    #: as an extra FoldResult labeled "nosk" (reference presk_fold fork +
    #: ".nosk" Archiver, LoadToFold1.C:458-501)
    sk_also_unzapped: bool = False

    def detection_state(self) -> Signal:
        if self.detection:
            return {
                "intensity": Signal.INTENSITY, "ppqq": Signal.PPQQ,
                "pp": Signal.PP, "qq": Signal.QQ,
                "coherence": Signal.COHERENCE, "stokes": Signal.STOKES,
                "nthpower": Signal.NTHPOWER,
            }[self.detection.lower()]
        return {1: Signal.INTENSITY, 2: Signal.PPQQ, 3: Signal.NTHPOWER,
                4: Signal.STOKES}[self.npol_out]


@dataclass
class FoldResult:
    """The PhaseSeries equivalent (``Signal/Pulsar/dsp/PhaseSeries.h``)."""

    profiles: np.ndarray  # [nsub, nchan, npol, nbin]
    hits: np.ndarray  # [nsub, nchan, nbin]
    epochs: list  # MJD of each subint's first folded data (TimeDivide start)
    integration_length: np.ndarray  # seconds per subint
    obs: Observation  # output-domain observation (channelized, detected)
    nbin: int = 0
    folding_period: float = 0.0
    dispersion_measure: float = 0.0
    cyclic_nlag: int = 0  # >0: profiles hold folded lag planes
    cyclic_mover: int = 1
    cyclic_npol: int = 1
    #: ordered op-chain provenance (reference SignalPath/dspReduction:
    #: Kernel/Classes/dsp/SignalPath.h, attached to archives by Archiver)
    signal_path: Optional[list] = None
    #: [2**nbit] digitizer state counts over the run (DigitiserCounts)
    digitizer_counts: Optional[np.ndarray] = None
    #: FoldResults of the additional pulsars folded in the same pass
    extra_sources: Optional[list] = None
    #: output tag for extra results ("nosk" for the -noskz_too un-zapped
    #: fold, used as the archive extension; None for additional pulsars)
    label: Optional[str] = None
    #: integrated pre-response bandpass [nchan, npol, freq_res]
    #: (reference Passband extension source)
    passband: Optional[np.ndarray] = None
    #: -Y pdmp extras: [nchan, npol, 4] running moment sums S1..S4 plus
    #: the folded sample count in pdmp_nsamp
    pdmp_stats: Optional[np.ndarray] = None
    pdmp_nsamp: int = 0
    #: the predictor/ephemeris used, for archive POLYCO / PSRPARAM tables
    #: (reference Archiver attaches polycos + Parameters)
    predictor: Optional[object] = None
    ephemeris: Optional[object] = None

    def normalized(self) -> np.ndarray:
        """Profiles divided by hits (the archive convention,
        ``Archiver.C:407-773`` raw_to_central)."""
        h = np.maximum(self.hits[:, :, None, :], 1.0)
        return self.profiles / h

    def to_stokes(self) -> "FoldResult":
        """Convert 4-pol COHERENCE profiles (PP, QQ, Re[P*Q], Im[P*Q]) to
        Stokes I,Q,U,V — the conversion the reference applies at archive
        time (``Detection.C:42-66`` conventions; PSRCHIVE
        ``Integration::convert_state``): I=PP+QQ, Q=PP-QQ, U=2 Re[p*q],
        V=2 Im[p*q] (``stokes_detect.ic:38-43``; ops.detection stores the
        coherence cross terms WITHOUT the factor 2)."""
        from ..observation import Signal as _S

        if self.obs.state != _S.COHERENCE:
            raise ValueError(f"not coherence data: {self.obs.state}")
        pp, qq = self.profiles[:, :, 0], self.profiles[:, :, 1]
        re, im = self.profiles[:, :, 2], self.profiles[:, :, 3]
        stokes = np.stack([pp + qq, pp - qq, 2.0 * re, 2.0 * im], axis=2)
        return dataclasses.replace(
            self, profiles=stokes, obs=self.obs.replace(state=_S.STOKES))

    def cyclic_spectra(self) -> np.ndarray:
        """Phase-resolved cyclic spectra from folded lag planes
        (reference ``CyclicFoldEngine::synch``); see ops.cyclic."""
        from ..ops.cyclic import cyclic_spectra

        if not self.cyclic_nlag:
            raise ValueError("not a cyclic fold result")
        out = []
        for s in range(self.profiles.shape[0]):
            out.append(cyclic_spectra(
                self.normalized()[s].astype(np.float64),
                self.cyclic_nlag, self.cyclic_mover, self.cyclic_npol))
        return np.stack(out)

    def dedispersed(self, ref_freq: float | None = None) -> np.ndarray:
        """Normalized profiles with inter-channel dispersion delays rotated
        out (PSRCHIVE ``Archive::dedisperse`` equivalent; the time-domain
        analogue is the reference's ``SampleDelay`` -K op).

        Each channel is rotated by -delay(f_chan, f_ref)/period turns using
        an FFT phase ramp (fractional-bin rotation).
        """
        from ..ops.dedispersion import delay_time

        prof = self.normalized()
        if self.dispersion_measure == 0 or self.folding_period <= 0:
            return prof
        obs = self.obs
        if ref_freq is None:
            ref_freq = obs.centre_frequency
        nbin = prof.shape[-1]
        k = np.fft.rfftfreq(nbin) * nbin  # 0..nbin/2
        out = np.empty_like(prof)
        for c in range(obs.nchan):
            dphi = delay_time(self.dispersion_measure,
                              obs.centre_frequency_of(c), ref_freq) / self.folding_period
            ramp = np.exp(2j * np.pi * k * dphi)  # advance by dphi turns
            spec = np.fft.rfft(prof[:, c], axis=-1) * ramp
            out[:, c] = np.fft.irfft(spec, n=nbin, axis=-1)
        return out


class FoldPipeline:
    """Constructed, prepared fold pipeline over one Source."""

    def __init__(self, source: Source, config: FoldConfig):
        self.source = source
        self.config = config
        self.obs_in = source.obs
        self._construct()

    # ---- construction (LoadToFold::construct/prepare equivalents) ----

    def _source_dm(self, spec) -> Optional[float]:
        """DM recorded for an additional source (None = primary DM)."""
        if isinstance(spec, (int, float)):
            return None
        s = str(spec)
        try:
            if s.endswith(".par"):
                return Ephemeris.load(s).dm
            from ..timing.polyco import Polyco

            from ..timing.t2pred import load_predictor
            p = load_predictor(s)
            if isinstance(p, Polyco) and p.blocks:
                return p.blocks[0].dm
        except Exception:
            return None
        return None

    def _make_predictor(self, spec):
        """Predictor from a multi-pulsar spec: a float period, a polyco /
        TEMPO2 predictor path, or a .par ephemeris path."""
        obs = self.obs_in
        if isinstance(spec, (int, float)):
            return FixedPeriodPredictor(float(spec), obs.start_time)
        s = str(spec)
        if s.endswith(".par"):
            from ..timing.polyco import SpinPredictor

            return SpinPredictor.from_ephemeris(
                Ephemeris.load(s), telescope=obs.telescope)
        from ..timing.t2pred import T2Predictor, load_predictor

        p = load_predictor(s)
        if isinstance(p, T2Predictor):
            p.obsfreq = obs.centre_frequency
        return p

    def _construct(self):
        cfg = self.config
        obs = self.obs_in

        # --- predictor & DM (LoadToFold::prepare, LoadToFold1.C:676-744) ---
        self.ephemeris = Ephemeris.load(cfg.ephemeris_path) if cfg.ephemeris_path else None
        if cfg.folding_period:
            epoch = obs.start_time
            if cfg.reference_epoch is not None:
                # --cepoch: phase zero anchored at a chosen MJD
                epoch = MJD.from_mjd(float(cfg.reference_epoch))
            self.predictor = FixedPeriodPredictor(cfg.folding_period, epoch)
        elif cfg.polyco_path:
            # -P accepts either a TEMPO polyco or a TEMPO2 ChebyModelSet
            # (auto-detected, as Pulsar::Predictor::load does)
            from ..timing.t2pred import T2Predictor, load_predictor
            self.predictor = load_predictor(cfg.polyco_path)
            if isinstance(self.predictor, T2Predictor):
                self.predictor.obsfreq = obs.centre_frequency
        elif self.ephemeris is not None:
            # no external TEMPO available: evaluate the ephemeris spin model
            # directly (see SpinPredictor docstring for validity bounds)
            from ..timing.polyco import SpinPredictor
            self.predictor = SpinPredictor.from_ephemeris(
                self.ephemeris, telescope=obs.telescope)
        elif obs.mode == "CAL" and obs.calfreq > 0:
            # CAL-mode folding: fold at the pulsed-cal square-wave frequency
            # (reference Fold::prepare CAL branch, Fold.C:190-227)
            self.predictor = FixedPeriodPredictor(1.0 / obs.calfreq,
                                                  obs.start_time)
        else:
            raise ValueError("need folding_period, polyco_path, "
                             "ephemeris_path, or MODE=CAL with CALFREQ")

        # extra pulsars folded in the same pass (reference multi-fold:
        # LoadToFold::configure_fold builds one Fold per source,
        # LoadToFold1.C:1155-1242)
        self.predictors = [self.predictor]
        for spec in (cfg.additional_pulsars or ()):
            self.predictors.append(self._make_predictor(spec))
        #: -noskz_too: the un-zapped fold is a SECOND fold sharing the
        #: primary predictor, fed the pre-SK weights (the reference forks
        #: the pre-SK stream into its own Fold + ".nosk" Archiver,
        #: LoadToFold1.C:458-501); it reuses the multi-source accumulator
        #: machinery end to end
        self._presk_index = None
        if cfg.sk_enable and cfg.sk_also_unzapped:
            self._presk_index = len(self.predictors)
            self.predictors.append(self.predictor)

        if self.ephemeris is not None and not obs.coordinates:
            raj = self.ephemeris.get("RAJ")
            decj = self.ephemeris.get("DECJ")
            if raj and decj:
                self.obs_in = obs = obs.replace(coordinates=f"{raj} {decj}")

        dm = cfg.dispersion_measure
        if dm is None and self.ephemeris is not None:
            dm = self.ephemeris.dm
        if dm is None and isinstance(self.predictor, Polyco):
            dm = self.predictor.blocks[0].dm
        if dm is None:
            from ..timing.t2pred import T2Predictor
            if isinstance(self.predictor, T2Predictor) and self.predictor.models:
                # DISPERSION_CONSTANT = -DM/2.41e-4 * F0 (see t2pred.py)
                m = self.predictor.models[0]
                f0 = self.predictor.frequency(obs.start_time)
                if f0 > 0 and m.dispersion_constant != 0.0:
                    dm = -m.dispersion_constant * 2.41e-4 / f0
        if dm is None:
            dm = obs.dispersion_measure
        self.dm = float(dm or 0.0)

        # --- unpacker ---
        self.unpack_plan = UnpackPlan(
            obs,
            twos_complement=cfg.twos_complement,
            dynamic_twobit=cfg.dynamic_twobit,
            ndat_per_weight=cfg.ndat_per_weight,
            cutoff_sigma=cfg.cutoff_sigma,
        )

        # --- channelization / convolution geometry ---
        real_input = obs.state == Signal.NYQUIST
        self.nchan_subband = max(1, cfg.nchan // obs.nchan) if cfg.nchan else 1
        nchan_out = obs.nchan * self.nchan_subband

        if cfg.coherent and self.dm > 0:
            # smearing per *output* channel in complex samples at the output rate
            from ..ops.dedispersion import Dedispersion as D

            nfp = D._half_smearing_samples(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out, +1, 0.1)
            nfn = D._half_smearing_samples(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out, -1, 0.1)
        else:
            nfp = nfn = 0
        nfilt_tot = nfp + nfn

        def _min_pow2_over(n):
            """Smallest power of two strictly exceeding the kernel length
            (the minimum valid overlap-save transform; the reference's
            times_minimum_nfft multiplies this, dspsr.C:774-782)."""
            m = 1
            while m <= n:
                m *= 2
            return m

        if self.nchan_subband > 1:
            # convolving filterbank (convolve_when=During): freq_res from the
            # smear (Filterbank::make_preparations, Filterbank.C:55-263);
            # incoherent filterbank defaults to critical sampling (freq_res=1,
            # the reference TFPFilterbank-style channelizer)
            if cfg.frequency_resolution:
                freq_res = cfg.frequency_resolution
            elif nfilt_tot == 0:
                freq_res = 1
            elif cfg.times_minimum_nfft:
                freq_res = cfg.times_minimum_nfft * _min_pow2_over(nfilt_tot)
            elif cfg.use_fft_bench:
                from ..utils.optimalfft import OptimalFFT
                freq_res = OptimalFFT().get_best_ndat(
                    nfilt_tot, max_nfft=cfg.max_nfft)
            else:
                freq_res = choose_nfft(nfilt_tot, max_nfft=cfg.max_nfft)
            self.fb_plan = FilterbankPlan(
                real_input=real_input,
                nchan_subband=self.nchan_subband,
                freq_res=freq_res,
                nfilt_pos=nfp,
                nfilt_neg=nfn,
            )
            self.fb_plan.validate()
            self.conv_plan = None
            self.obs_stream = update_observation(obs, self.fb_plan)
            ndat_fft = freq_res
        else:
            if cfg.frequency_resolution:
                n_fft = cfg.frequency_resolution
            elif cfg.times_minimum_nfft and nfilt_tot > 0:
                n_fft = cfg.times_minimum_nfft * _min_pow2_over(nfilt_tot)
            elif cfg.use_fft_bench and nfilt_tot > 0:
                from ..utils.optimalfft import OptimalFFT
                n_fft = OptimalFFT().get_best_ndat(
                    nfilt_tot, max_nfft=cfg.max_nfft)
            else:
                n_fft = choose_nfft(nfilt_tot, max_nfft=cfg.max_nfft)
            if cfg.coherent and self.dm > 0:
                self.conv_plan = OverlapSavePlan(real_input, n_fft, nfp, nfn)
                self.conv_plan.validate()
            else:
                self.conv_plan = None
            self.fb_plan = None
            rate = obs.rate / (2 if real_input else 1)
            self.obs_stream = obs.replace(
                state=Signal.ANALYTIC, ndim=2,
                rate=rate if (self.conv_plan or not real_input) else obs.rate,
            ) if (self.conv_plan or obs.state == Signal.ANALYTIC) else obs
            ndat_fft = n_fft

        # --- chirp (Dedispersion::match/build; LoadToFold1.C:199-241) ---
        if cfg.coherent and self.dm > 0:
            builder = (Dedispersion.build_interchannel_aligned
                       if cfg.interchannel_align else Dedispersion.build)
            self.kernel = builder(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out, ndat_fft)
            if cfg.interchannel_align and not cfg.frequency_resolution:
                # the -K delay ramps can need far more overlap cover than the
                # intra-channel smear: grow the FFT until it fits
                # (Response::set_optimal_ndat role)
                while (self.kernel.impulse_total >= ndat_fft
                       and ndat_fft < cfg.max_nfft):
                    ndat_fft = choose_nfft(self.kernel.impulse_total,
                                           max_nfft=cfg.max_nfft)
                    self.kernel = builder(self.dm, obs.centre_frequency,
                                          obs.bandwidth, nchan_out, ndat_fft)
                if self.fb_plan is not None and \
                        ndat_fft != self.fb_plan.freq_res:
                    self.fb_plan = FilterbankPlan(
                        real_input=self.fb_plan.real_input,
                        nchan_subband=self.fb_plan.nchan_subband,
                        freq_res=ndat_fft,
                        nfilt_pos=self.fb_plan.nfilt_pos,
                        nfilt_neg=self.fb_plan.nfilt_neg)
                elif self.conv_plan is not None and \
                        ndat_fft != self.conv_plan.n_fft:
                    self.conv_plan = OverlapSavePlan(
                        self.conv_plan.real_input, ndat_fft,
                        self.conv_plan.nfilt_pos, self.conv_plan.nfilt_neg)
            if cfg.interchannel_align and self.fb_plan is not None:
                # delay ramp needs overlap cover: rebuild the plan with the
                # enlarged impulse_pos
                self.fb_plan = FilterbankPlan(
                    real_input=self.fb_plan.real_input,
                    nchan_subband=self.fb_plan.nchan_subband,
                    freq_res=self.fb_plan.freq_res,
                    nfilt_pos=self.kernel.impulse_pos,
                    nfilt_neg=self.kernel.impulse_neg)
                self.fb_plan.validate()
                self.obs_stream = update_observation(obs, self.fb_plan)
            elif cfg.interchannel_align and self.conv_plan is not None:
                self.conv_plan = OverlapSavePlan(
                    self.conv_plan.real_input, self.conv_plan.n_fft,
                    self.kernel.impulse_pos, self.kernel.impulse_neg)
                self.conv_plan.validate()
            nfp = self.kernel.impulse_pos
            nfn = self.kernel.impulse_neg
            if self.fb_plan is not None:
                rr, ri = sc.from_numpy(self.kernel.phasors)
                self._response_natural = (jnp.asarray(rr), jnp.asarray(ri))
                self._response_fftorder = None
            else:
                self._response_natural = None
                rr, ri = sc.from_numpy(
                    Response(self.kernel.phasors, nfp, nfn).fft_order(
                        complex_input=not real_input))
                self._response_fftorder = (jnp.asarray(rr), jnp.asarray(ri))
        else:
            self.kernel = None
            self._response_natural = None
            self._response_fftorder = None

        # --- polarization calibration (PolnCalibration.C; matrix
        # convolution Convolution.C:425-436) ---
        if cfg.calibration_path:
            from ..ops.polncal import (
                PolnCalibration, jones_fft_order, jones_product)

            if self.nchan_subband > 1:
                raise NotImplementedError(
                    "Jones calibration inside the convolving filterbank is "
                    "not supported; calibrate at the input channelization "
                    "(reference: matrix convolution lives in Convolution)")
            if obs.npol != 2:
                raise ValueError("Jones calibration needs npol=2 input")
            epoch = obs.start_time.days + obs.start_time.fracday()
            cal = PolnCalibration.load(cfg.calibration_path, epoch_mjd=epoch)
            if self.conv_plan is None:
                # pure-calibration convolution (no dedispersion)
                n_fft = cfg.frequency_resolution or 256
                self.conv_plan = OverlapSavePlan(real_input, n_fft, 0, 0)
                self.conv_plan.validate()
                rate = obs.rate / (2 if real_input else 1)
                self.obs_stream = obs.replace(
                    state=Signal.ANALYTIC, ndim=2, rate=rate)
            jones = cal.match(obs, nchan_out, self.conv_plan.n_fft)
            scalar = (Response(self.kernel.phasors, nfp, nfn)
                      if self.kernel is not None else None)
            resp = jones_product(scalar, jones)
            self._jones_fftorder = jones_fft_order(
                resp, complex_input=not real_input)
            #: natural-order Jones response (the float64 reference model
            #: in dspsr_jax.golden consumes it)
            self.jones_response = resp.phasors
            self._response_fftorder = None
        else:
            self._jones_fftorder = None
            self.jones_response = None

        # --- cyclic fold (CyclicFold.C; folds lag products, not power) ---
        if cfg.cyclic_nchan:
            from ..ops.cyclic import CyclicPlan

            self.cyclic_plan = CyclicPlan(cfg.cyclic_nchan, cfg.cyclic_mover)
        else:
            self.cyclic_plan = None

        # --- detection ---
        self.det_state = cfg.detection_state()
        self.obs_out = self.obs_stream.apply_detection(self.det_state)
        if self.cyclic_plan is not None:
            npol_in = self.obs_stream.npol
            self.obs_out = self.obs_stream.replace(
                npol=npol_in * self.cyclic_plan.nlag * 2, ndim=1)
        if cfg.fourth_moment:
            if cfg.npol_out != 4:
                raise ValueError("fourth_moment requires npol_out=4 (Stokes)")
            self.obs_out = self.obs_out.replace(npol=14)

        # --- spectral kurtosis (SpectralKurtosis.C; applied post-detection) -
        self.sk_plan = SKPlan(
            cfg.sk_m, cfg.sk_std_devs,
            detect_tscr=not cfg.sk_no_tscr,
            detect_fscr=not cfg.sk_no_fscr,
            chan_start=cfg.sk_chan_start,
            chan_end=cfg.sk_chan_end,
        ) if cfg.sk_enable else None

        # --- fold plan (Fold::prepare; choose_nbin Fold.C:275-382) ---
        # per-source geometry: each pulsar gets its own nbin from its own
        # period (reference: one Fold per source with its own choose_nbin,
        # LoadToFold1.C:990-1092); an explicit -b applies to every fold,
        # exactly as the reference passes Config nbin to each Fold
        tsamp_out = 1.0 / self.obs_out.rate
        self.nbins = [choose_nbin(p.period(obs.start_time), tsamp_out,
                                  cfg.nbin) for p in self.predictors]
        self.nbin = self.nbins[0]
        period = self.predictor.period(obs.start_time)
        self.folding_period = period
        self.fold_plan = FoldPlan(nbin=self.nbin, seg_len=cfg.seg_len)
        # per-source DM for the output archives (reference ObservationChange
        # carries each source's DM to its Archiver; the dedispersion chirp
        # itself stays at the primary DM, as in the reference)
        self.source_dms = [None]
        for spec in (cfg.additional_pulsars or ()):
            self.source_dms.append(self._source_dm(spec))
        if self._presk_index is not None:
            self.source_dms.append(None)

        # --- block geometry ---
        self._plan_blocks()

        # --- apodization window (built at the final FFT geometry) ---
        if cfg.fft_window:
            from ..ops.apodization import WindowType, build_window

            nsamp_fft = (self.fb_plan.nsamp_fft if self.fb_plan is not None
                         else (self.conv_plan.nsamp_fft
                               if self.conv_plan is not None else 0))
            if nsamp_fft == 0:
                raise ValueError("fft_window needs an FFT stage")
            self._apodization = jnp.asarray(
                build_window(WindowType(cfg.fft_window), nsamp_fft))
        else:
            self._apodization = None

        # per-source fold plans share the (possibly shrunk) segment length
        self.fold_plans = [FoldPlan(nb, self.fold_plan.seg_len)
                           for nb in self.nbins]

        # --- accumulators ---
        nchan, npol = self.obs_out.nchan, self.obs_out.npol
        nsrc = len(self.predictors)
        if nsrc > 1:
            # per-source accumulators (each source its own nbin): a pytree
            # of arrays instead of one stacked array
            self._profiles = tuple(
                jnp.zeros((nchan, npol, nb), jnp.float32)
                for nb in self.nbins)
            self._hits = tuple(
                jnp.zeros((nchan, nb), jnp.float32) for nb in self.nbins)
        else:
            self._profiles = jnp.zeros((nchan, npol, self.nbin), jnp.float32)
            self._hits = jnp.zeros((nchan, self.nbin), jnp.float32)
        self._subints: list[FoldResult] = []
        self._current_div = 0
        self._div_samples = 0.0
        self._first_out_time: Optional[MJD] = None
        self._last_out_time: Optional[MJD] = None
        #: epoch of the first data folded into the current division (the
        #: TRUE subint start, reference TimeDivide division bookkeeping —
        #: not the arrival time of some later block)
        self._div_first_time: Optional[MJD] = None
        #: sample-exact division bookkeeping (set by run() when -L/--turns)
        self._divider = None
        self._byte_counts = np.zeros(256, np.int64)
        self._passband = None
        self._pdmp_stats = None
        self._pdmp_nsamp = 0

    def signal_path(self) -> list:
        """Ordered record of the constructed op chain with its resolved
        parameters (reference ``dsp::SignalPath`` + the dspReduction
        history the Archiver attaches, ``Kernel/Classes/dsp/SignalPath.h``,
        ``Signal/Pulsar/Archiver.C``)."""
        cfg = self.config
        obs = self.obs_in
        path: list = [{
            "op": "Source", "format": obs.format,
            "file": getattr(self.source, "path", None),
            "nchan": obs.nchan, "npol": obs.npol, "nbit": obs.nbit,
        }, {
            "op": "Unpack", "nbit": obs.nbit,
            "twos_complement": cfg.twos_complement,
            "ndat_per_weight": cfg.ndat_per_weight,
            "cutoff_sigma": cfg.cutoff_sigma,
        }]
        if self.kernel is not None:
            path.append({
                "op": "Dedispersion", "dm": self.dm,
                "impulse_pos": self.kernel.impulse_pos,
                "impulse_neg": self.kernel.impulse_neg,
                "interchannel_align": cfg.interchannel_align,
            })
        if self.fb_plan is not None:
            path.append({
                "op": "Filterbank",
                "nchan_subband": self.fb_plan.nchan_subband,
                "freq_res": self.fb_plan.freq_res,
                "convolve_when": "During" if self.kernel is not None else "Never",
            })
        if self.conv_plan is not None:
            path.append({
                "op": "Convolution", "n_fft": self.conv_plan.n_fft,
                "matrix": self._jones_fftorder is not None,
            })
        if cfg.calibration_path:
            path.append({"op": "PolnCalibration",
                         "database": cfg.calibration_path})
        if cfg.rfi_filter:
            path.append({"op": "RFIFilter",
                         "median_width": cfg.rfi_median_width,
                         "threshold": cfg.rfi_threshold})
        if self.sk_plan is not None:
            path.append({"op": "SpectralKurtosis", "m": cfg.sk_m,
                         "std_devs": cfg.sk_std_devs})
        if self.cyclic_plan is not None:
            path.append({"op": "CyclicFold", "nlag": self.cyclic_plan.nlag,
                         "mover": self.cyclic_plan.mover})
        else:
            path.append({"op": "Detection", "state": self.det_state.value})
        if cfg.fourth_moment:
            path.append({"op": "FourthMoment"})
        path.append({
            "op": "Fold", "nbin": self.nbin,
            "predictor": type(self.predictor).__name__,
            "folding_period": self.folding_period,
            "reference_phase": cfg.reference_phase,
        })
        if cfg.subint_seconds > 0 or cfg.subint_turns > 0:
            path.append({"op": "Subint",
                         "seconds": cfg.subint_seconds,
                         "turns": cfg.subint_turns})
        return path

    def _plan_blocks(self):
        cfg = self.config
        if self.fb_plan is not None:
            p = self.fb_plan
        elif self.conv_plan is not None:
            p = self.conv_plan
        else:
            p = None
        if p is not None:
            self.nsamp_step = p.nsamp_step
            self.nsamp_overlap = p.nsamp_overlap
            # grow blocks toward min_block_samples to amortize dispatch
            # overhead, but never beyond the source (so short files still
            # yield a full block) nor beyond a subint (so -L granularity
            # holds at block level)
            want = -(-cfg.min_block_samples // p.nsamp_step)
            avail = self.source.total_samples
            if cfg.seek_seconds > 0 and self.obs_in.rate > 0:
                avail = max(avail - int(cfg.seek_seconds * self.obs_in.rate),
                            p.block_ndat(1))
            cap = p.npart(avail)
            if cfg.subint_seconds > 0 and self.obs_in.rate > 0:
                sub_samps = int(cfg.subint_seconds * self.obs_in.rate)
                cap = min(cap, max(p.npart(sub_samps), 1))
            if cfg.subint_turns > 0 and self.obs_in.rate > 0:
                period = self.predictor.period(self.obs_in.start_time)
                sub_samps = int(cfg.subint_turns * period * self.obs_in.rate)
                cap = min(cap, max(p.npart(sub_samps), 1))
            self.npart = min(max(want, cfg.block_parts), cap) if cap > 0 \
                else cfg.block_parts
            self.block_in_samples = p.block_ndat(self.npart)
            nkeep = p.nkeep if self.fb_plan is not None else p.nkeep_c
            out_per_block = self.npart * nkeep
        else:
            # no FFT stage: plain blocks sized to the sample budget (and the
            # source; detection of a real stream keeps it real at full rate)
            block = min(cfg.min_block_samples, self.source.total_samples)
            block = max((block // 4096) * 4096, 4096)
            self.nsamp_step = block
            self.nsamp_overlap = 0
            self.npart = 1
            self.block_in_samples = block
            out_per_block = block

        # cyclic fold consumes nlag-1 samples building lag products
        if getattr(self, "cyclic_plan", None) is not None:
            out_per_block -= self.cyclic_plan.nlag - 1

        # the fold pads the block's trailing partial segment with zero
        # weights (see _step_core), so seg_len need not divide the output;
        # clamp only so a tiny block doesn't drown in padding.  (Round 2
        # shrank seg to a divisor instead, which could collapse to seg=1 on
        # odd geometries — thousands of host polyco evaluations per block.)
        seg = self.config.seg_len
        while seg > 1 and seg > out_per_block:
            seg //= 2
        if seg != self.fold_plan.seg_len:
            self.fold_plan = FoldPlan(self.nbin, seg)
        self.out_per_block = out_per_block
        self.stride_in_samples = self.npart * self.nsamp_step

    # ---- the jitted device step ----

    @partial(jax.jit, static_argnames=("self",),
             donate_argnames=("profiles", "hits"))
    def _step(self, profiles, hits, raw, phi0, dphi, bounds=None):
        return self._step_core(profiles, hits, raw, phi0, dphi,
                               bounds=bounds)

    @partial(jax.jit, static_argnames=("self",),
             donate_argnames=("profiles", "hits"))
    def _step_multi(self, profiles, hits, raws, phi0s, dphis, bounds=None):
        """Process a stack of blocks in ONE dispatch (lax.scan over blocks).

        The host batches ``blocks_per_step`` blocks per call to amortize
        the per-dispatch cost — the device-side analogue of the reference's
        block-size-from-RAM-budget tuning.  ``bounds`` (shared
        by every block of the batch) exists so a sub-integration run keeps
        ONE compiled program: batches are only formed from whole blocks
        inside one division, so the span is always the full block.
        """
        def body(carry, inp):
            prof, h = carry
            raw, p0, dp = inp
            return self._step_core(prof, h, raw, p0, dp,
                                   bounds=bounds), None

        (profiles, hits), _ = jax.lax.scan(
            body, (profiles, hits), (raws, phi0s, dphis))
        return profiles, hits

    def _step_core(self, profiles, hits, raw, phi0, dphi,
                   chan_ix=None, n_chan_shards=1, bounds=None):
        """One block through the op chain.

        ``chan_ix``/``n_chan_shards``: when called inside a channel-sharded
        ``shard_map`` (parallel.pipeline), process only output channels
        ``[chan_ix*local, (chan_ix+1)*local)`` — the slice happens between
        the big forward FFT and the per-subband inversion (the reference's
        MPITrans channel scatter point).  ``profiles``/``hits`` are then the
        local channel slices.

        ``bounds``: optional traced int32[2] = [lo, hi) output-sample span
        to fold (sample-exact TimeDivide division bounds; samples outside
        get zero fold weight, reference ``SubFold::set_limits``).
        """
        from ..ops.filterbank import (
            forward_spectra_chunked, apply_response_chunked, invert_subbands)

        sharded = chan_ix is not None and n_chan_shards > 1
        nchan_total = self.obs_out.nchan
        local = nchan_total // n_chan_shards if sharded else nchan_total

        # the named scopes label the device kernels of each layer in a
        # profiler trace (bench.py --layers)
        with jax.named_scope("unpack"):
            x, w = self.unpack_plan.unpack(raw)
        # w: [nchan_in, nweights] block weights or None
        rfi = ((self.config.rfi_median_width, self.config.rfi_threshold)
               if self.config.rfi_filter else None)
        pb = None
        if self.fb_plan is not None:
            with jax.named_scope("forward_fft"):
                spec = forward_spectra_chunked(x, self.fb_plan, self.npart,
                                               self._apodization)
            if self.config.passband:
                # integrated pre-response bandpass (reference Response
                # passband integration during Convolution -> Archiver
                # Passband extension)
                pb = jnp.sum(spec[0] * spec[0] + spec[1] * spec[1], axis=2)
            resp = self._response_natural
            if sharded:
                spec = tuple(jax.lax.dynamic_slice_in_dim(
                    a, chan_ix * local, local, 0) for a in spec)
                if resp is not None:
                    resp = tuple(jax.lax.dynamic_slice_in_dim(
                        r, chan_ix * local, local, 0) for r in resp)
            with jax.named_scope("response"):
                spec = apply_response_chunked(
                    spec, resp, rfi_zap=rfi,
                    nchan_sub_present=min(self.fb_plan.nchan_subband, local))
            with jax.named_scope("inverse_fft"):
                y = invert_subbands(spec, self.fb_plan)
        elif self.conv_plan is not None:
            resp_f = self._response_fftorder
            jones = self._jones_fftorder
            if sharded:
                # nchan_subband == 1: slice input channels directly
                def sl(a):
                    return jax.lax.dynamic_slice_in_dim(
                        a, chan_ix * local, local, 0)

                x = sl(x) if not isinstance(x, tuple) else (sl(x[0]), sl(x[1]))
                if resp_f is not None:
                    resp_f = (sl(resp_f[0]), sl(resp_f[1]))
                if jones is not None:
                    jones = tuple((sl(r), sl(i)) for (r, i) in jones)
            plan = self.conv_plan
            with jax.named_scope("forward_fft"):
                spec = convolution.forward_spectra(x, plan, self.npart,
                                                   self._apodization)
            if self.config.passband:
                pb = convolution.bandpass(spec, plan)
            with jax.named_scope("response"):
                if rfi is not None:
                    spec = convolution.zap_rfi(spec, plan, *rfi)
                if jones is not None:
                    spec = convolution.apply_jones(spec, jones)
                else:
                    spec = convolution.apply_response(spec, resp_f)
            with jax.named_scope("inverse_fft"):
                y = convolution.invert_windows(spec, plan)
        else:
            if sharded:
                def sl(a):
                    return jax.lax.dynamic_slice_in_dim(
                        a, chan_ix * local, local, 0)

                x = sl(x) if not isinstance(x, tuple) else (sl(x[0]), sl(x[1]))
            y = x
        weights = self._stream_weights(
            w, self.obs_out.nchan // (n_chan_shards if sharded else 1),
            self._tail_ndat(y), chan_ix=chan_ix,
            n_chan_shards=n_chan_shards)
        return self._fold_tail(
            profiles, hits, y, weights, phi0, dphi, pb=pb, bounds=bounds,
            sk_ctx=(("chan", nchan_total, chan_ix * local)
                    if sharded else None))

    def _tail_ndat(self, y) -> int:
        """Detected samples the tail will fold from voltage stream ``y``."""
        ndat = (y[0] if isinstance(y, tuple) else y).shape[2]
        if self.cyclic_plan is not None:
            ndat -= self.cyclic_plan.nlag - 1
        return ndat

    def _fold_tail(self, profiles, hits, y, weights, phi0, dphi, pb=None,
                   bounds=None, sk_ctx=None):
        """The tail of the chain: cyclic lag products / detection / fourth
        moments / in-stream SK / the (multi-source) fold / dump+passband
        extras.

        ``y``: voltage stream (SC pair, or real array when no FFT stage);
        ``weights``: per-sample [nchan_out(_local), ndat_out] excision
        weights (before the SK mask, which is computed here from ``y``).
        ``bounds``: int32[2] = [lo, hi) output-sample fold span (TimeDivide
        sample-exact division bounds) — applied as a per-sample zero weight
        outside the span, so hits/profiles count exactly the division's
        samples.
        """
        with jax.named_scope("detect"):
            if self.cyclic_plan is not None:
                from ..ops.cyclic import lag_planes

                d = lag_planes(y, self.cyclic_plan.nlag)
            else:
                d = detect(y, self.det_state)
        power = None
        if self.sk_plan is not None:
            if isinstance(y, tuple):
                power = y[0] * y[0] + y[1] * y[1]  # per-pol |x|^2
            else:
                power = y * y
        if self.config.fourth_moment:
            from ..ops.fourth_moment import fourth_moment

            d = fourth_moment(d)
        nchan = d.shape[0]
        ndat_out = d.shape[2]
        # every output sample folds: the trailing partial segment is padded
        # to seg_len with zero WEIGHTS (the reference folds whole blocks,
        # Fold.C:835-873; zero weight == excluded sample)
        seg = self.fold_plan.seg_len
        nuse = -(-ndat_out // seg) * seg
        pad = nuse - ndat_out
        dump = (jnp.transpose(d, (2, 0, 1)).astype(jnp.float32)
                if self.config.dump_path else None)
        mom = None
        if self.config.pdmp_stats:
            # -Y pdmp extras: running moments of the detected stream per
            # (chan, pol) (reference Stats op, Signal/General/Stats.C)
            mom = jnp.stack([jnp.sum(d ** k, axis=2) for k in (1, 2, 3, 4)],
                            axis=-1)
        weights = weights[:, :ndat_out]
        if bounds is not None:
            idx = jnp.arange(ndat_out, dtype=jnp.int32)
            span = jnp.logical_and(idx >= bounds[0], idx < bounds[1])
            weights = weights * span.astype(jnp.float32)[None, :]
        w_presk = None
        if self._presk_index is not None:
            # -noskz_too: the un-zapped fold uses the weights BEFORE the
            # SK mask (base excision + division bounds only)
            w_presk = weights
        if self.sk_plan is not None:
            nblk = ndat_out // self.sk_plan.M
            if sk_ctx is not None:
                # channel-sharded shard_map: the fscr round pools S1/S2
                # over the mesh "chan" axis so thresholds use the global
                # Nd (single-device detection semantics; no local-Nd
                # deviation)
                axis, total, coff = sk_ctx
                skm = sk_mask(power, self.sk_plan, nblk, axis_name=axis,
                              nchan_total=total, chan_offset=coff)
            else:
                skm = sk_mask(power, self.sk_plan, nblk)
            skw = expand_mask(skm, self.sk_plan.M)
            skpad = ndat_out - skw.shape[-1]
            if skpad > 0:
                # trailing partial SK cell keeps weight 1
                skw = jnp.concatenate(
                    [skw, jnp.ones((nchan, skpad), jnp.float32)], axis=-1)
            weights = weights * skw[:, :ndat_out]
        if pad:
            d = jnp.concatenate(
                [d, jnp.zeros((*d.shape[:2], pad), d.dtype)], axis=-1)
            weights = jnp.concatenate(
                [weights, jnp.zeros((weights.shape[0], pad), jnp.float32)],
                axis=-1)
            if w_presk is not None:
                w_presk = jnp.concatenate(
                    [w_presk,
                     jnp.zeros((w_presk.shape[0], pad), jnp.float32)],
                    axis=-1)
        with jax.named_scope("fold"):
            if isinstance(profiles, (tuple, list)):
                # multi-pulsar: one fold per source over the shared detected
                # stream, each with ITS OWN nbin (phi0/dphi are [nsrc,
                # nseg]); the -noskz_too pseudo-source folds the pre-SK
                # weights
                ps, hs = [], []
                for s in range(len(profiles)):
                    w_s = (w_presk if s == self._presk_index
                           and w_presk is not None else weights)
                    p_, h_ = fold_block(profiles[s], hits[s], d, w_s,
                                        phi0[s], dphi[s], self.fold_plans[s])
                    ps.append(p_)
                    hs.append(h_)
                out = (tuple(ps), tuple(hs))
            else:
                out = fold_block(
                    profiles, hits, d, weights, phi0, dphi, self.fold_plan)
        extras = []
        if dump is not None:
            extras.append(dump)
        if pb is not None:
            extras.append(pb)
        if mom is not None:
            extras.append(mom)
        return (*out, *extras) if extras else out

    def _stream_weights(self, w, nchan, nuse, chan_ix=None, n_chan_shards=1):
        """Map unpacker block weights onto output samples.

        Matches the reference's conservative semantics
        (``WeightedTimeSeries::convolve_weights``): an output sample is bad
        if ANY input sample of the FFT window that produced it was bad.
        Implemented gather-free: min over each window's weight span (static
        slices), then broadcast each window's weight over its nkeep outputs.

        ``nchan`` is the number of output channels to produce (the local
        slice under channel sharding, selected by ``chan_ix``).
        """
        if w is None or w.shape[1] == 0:
            # block smaller than one weight span: no excision information
            return jnp.ones((nchan, nuse), jnp.float32)
        if chan_ix is not None and n_chan_shards > 1:
            nsub = (self.fb_plan.nchan_subband
                    if self.fb_plan is not None else 1)
            rows = max(nchan // nsub, 1)
            start = (chan_ix * nchan) // nsub
            w = jax.lax.dynamic_slice_in_dim(w, start, rows, 0)
        nchan_in, nweights = w.shape
        npw = self.config.ndat_per_weight

        if self.fb_plan is not None or self.conv_plan is not None:
            pl = self.fb_plan if self.fb_plan is not None else self.conv_plan
            step, nfft = pl.nsamp_step, pl.nsamp_fft
            nkeep = pl.nkeep if self.fb_plan is not None else pl.nkeep_c
            per_win = []
            for p in range(self.npart):
                a = min((p * step) // npw, nweights - 1)
                b = min((p * step + nfft + npw - 1) // npw, nweights)
                b = max(b, a + 1)  # window tail past the last whole weight
                # block inherits that block's weight (conservative)
                per_win.append(jnp.min(w[:, a:b], axis=1))
            wwin = jnp.stack(per_win, axis=1)  # [nchan_in, npart]
            expanded = jnp.broadcast_to(
                wwin[:, :, None], (nchan_in, self.npart, nkeep)
            ).reshape(nchan_in, self.npart * nkeep)[:, :nuse]
        else:
            # no FFT stage: output sample j maps to input sample j
            expanded = jnp.broadcast_to(
                w[:, :, None], (nchan_in, nweights, npw)
            ).reshape(nchan_in, nweights * npw)[:, :nuse]

        if nchan_in == nchan:
            return expanded
        reps = nchan // nchan_in
        return jnp.broadcast_to(
            expanded[:, None, :], (nchan_in, reps, expanded.shape[-1])
        ).reshape(nchan_in * reps, expanded.shape[-1])

    # ---- host streaming loop (SingleThread::run equivalent) ----

    def output_start_time(self, block_start_sample: int) -> MJD:
        """MJD of output sample 0 of the block starting at the given input
        sample (start-time shift by nfilt_pos; ``Convolution.C:300``,
        ``Filterbank.C:369``)."""
        t0 = self.obs_in.start_time + block_start_sample / self.obs_in.rate
        if self.kernel is not None or self.fb_plan is not None:
            return t0 + self.fold_plan_offset_seconds()
        return t0

    def fold_plan_offset_seconds(self) -> float:
        nfp = (self.fb_plan.nfilt_pos if self.fb_plan is not None
               else (self.conv_plan.nfilt_pos if self.conv_plan is not None else 0))
        return nfp / self.obs_out.rate

    def run(self, max_blocks: Optional[int] = None,
            total_seconds: Optional[float] = None,
            seek_seconds: Optional[float] = None) -> FoldResult:
        """Stream all blocks through the device step; returns the result.

        total_seconds limits input consumed (reference -T);
        seek_seconds skips that much input first (reference -S,
        ``SingleThread.C:694-719``).
        """
        from ..utils.report import RunReport

        src = self.source
        if seek_seconds is None:
            seek_seconds = self.config.seek_seconds
        seek = int(seek_seconds * self.obs_in.rate) if seek_seconds else 0
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total,
                              seek + int(total_seconds * self.obs_in.rate))

        rep = RunReport(enabled=self.config.report)
        start = seek
        nblocks = 0
        out_off = 0  # global output-sample index of the next block
        tsamp_out = 1.0 / self.obs_out.rate
        seg = self.fold_plan.seg_len
        # anchors cover the zero-weight-padded tail segment; the actual
        # folded sample count is exactly out_per_block (nothing dropped)
        nuse_pad = -(-self.out_per_block // seg) * seg
        nuse = self.out_per_block
        bps = self.config.blocks_per_step

        # sample-exact sub-integration divider (reference TimeDivide/
        # SubFold): blocks containing a boundary are folded once per
        # division with per-sample [lo, hi) bounds in the device step
        divider = None
        if self.config.subint_seconds > 0 or self.config.subint_turns > 0:
            from ..timing.timedivide import TimeDivide

            lep = self.config.integration_reference_epoch
            divider = TimeDivide(
                rate=self.obs_out.rate,
                start_time=self.output_start_time(seek),
                seconds=self.config.subint_seconds,
                turns=self.config.subint_turns,
                predictor=self.predictor,
                reference_phase=self.config.reference_phase,
                reference_epoch=(MJD.from_mjd(lep) if lep else None),
                fractional_pulses=self.config.fractional_pulses)
            self._divider = divider
        full_bounds = (jnp.asarray(np.array([0, nuse], np.int32))
                       if divider is not None else None)

        def open_division(dv: int, first_sample: int):
            if dv != self._current_div:
                self._flush_division()
                self._current_div = dv
            if self._div_first_time is None:
                self._div_first_time = divider.epoch_of(first_sample)

        while start + self.block_in_samples <= nsamp_total:
            # gather up to blocks_per_step whole blocks inside one subint
            # (exact-boundary decision: a block whose output spans a
            # division boundary is processed alone, split by bounds)
            batch = []
            batch_segs = None
            while (len(batch) < bps
                   and start + self.block_in_samples <= nsamp_total
                   and (max_blocks is None or nblocks + len(batch) < max_blocks)):
                segs = (divider.segments(out_off + len(batch) * nuse, nuse)
                        if divider is not None else None)
                if batch and segs is not None and (
                        len(segs) > 1 or segs[0][2] != batch_segs[0][2]):
                    break
                t_out0 = self.output_start_time(start)
                with rep.stage("read"):
                    raw = src.read_samples(start, self.block_in_samples)
                if self.config.digitizer_stats and self.obs_in.nbit <= 8:
                    self._byte_counts += np.bincount(raw, minlength=256)
                with rep.stage("anchors"):
                    if len(self.predictors) > 1:
                        pairs = [compute_anchors(p, t_out0, tsamp_out,
                                                 nuse_pad, seg)
                                 for p in self.predictors]
                        phi0 = np.stack([a for a, _ in pairs])
                        dphi = np.stack([b for _, b in pairs])
                    else:
                        phi0, dphi = compute_anchors(
                            self.predictor, t_out0, tsamp_out, nuse_pad, seg)
                phi0 = (phi0 - self.config.reference_phase) % 1.0
                if not batch:
                    batch_segs = segs
                batch.append((raw, phi0, dphi, t_out0))
                start += self.stride_in_samples
                if segs is not None and len(segs) > 1:
                    break  # boundary block: fold alone, one call per span
            if not batch:
                break

            with rep.stage("device_step"):
                if len(batch) == 1:
                    raw, phi0, dphi, t_out0 = batch[0]
                    spans = (batch_segs if divider is not None
                             else [(0, nuse, 0)])
                    took_extras = False
                    for (lo, hi, dv) in spans:
                        if dv < 0:
                            # data before the first division: discarded
                            # (TimeDivide::set_bounds idat_start skip)
                            continue
                        if divider is not None:
                            open_division(dv, out_off + lo)
                            bnd = (jnp.asarray(
                                np.array([lo, hi], np.int32)),)
                        else:
                            bnd = ()
                        res = self._step(
                            self._profiles, self._hits, jnp.asarray(raw),
                            jnp.asarray(phi0), jnp.asarray(dphi), *bnd)
                        self._profiles, self._hits = res[0], res[1]
                        if divider is not None:
                            self._div_samples += hi - lo
                        if took_extras:
                            continue
                        took_extras = True
                        k = 2
                        if self.config.dump_path and len(res) > k:
                            self._write_dump(np.asarray(res[k]))
                            k += 1
                        if self.config.passband and len(res) > k:
                            pbb = np.asarray(res[k], np.float64)
                            self._passband = (pbb if self._passband is None
                                              else self._passband + pbb)
                            k += 1
                        if self.config.pdmp_stats and len(res) > k:
                            mm = np.asarray(res[k], np.float64)
                            self._pdmp_stats = (
                                mm if self._pdmp_stats is None
                                else self._pdmp_stats + mm)
                            self._pdmp_nsamp += self.out_per_block
                else:
                    if divider is not None:
                        open_division(batch_segs[0][2], out_off)
                        self._div_samples += nuse * len(batch)
                    raws = jnp.asarray(np.stack([b[0] for b in batch]))
                    p0s = jnp.asarray(np.stack([b[1] for b in batch]))
                    dps = jnp.asarray(np.stack([b[2] for b in batch]))
                    self._profiles, self._hits = self._step_multi(
                        self._profiles, self._hits, raws, p0s, dps,
                        full_bounds)
            rep.add_samples(self.stride_in_samples * len(batch))
            if self.obs_in.rate > 0:
                rep.progress(start / self.obs_in.rate,
                             nsamp_total / self.obs_in.rate)
            if self._first_out_time is None:
                self._first_out_time = batch[0][3]
            if divider is None:
                if self._div_first_time is None:
                    self._div_first_time = batch[0][3]
                self._div_samples += nuse * len(batch)
            self._last_out_time = batch[-1][3] + nuse * tsamp_out
            out_off += nuse * len(batch)
            nblocks += len(batch)
            if max_blocks is not None and nblocks >= max_blocks:
                break

        self._flush_division()
        return self._finish()

    def _write_dump(self, tfp: np.ndarray):
        """Append TFP float32 samples to the dump DADA file (Dump op)."""
        import os

        from ..io.dada import format_ascii_header, header_from_observation

        path = self.config.dump_path
        if not os.path.exists(path):
            # the detected stream starts at the output-domain epoch (incl.
            # the nfilt_pos shift) and its blocks are nuse samples each
            obs = self.obs_out.replace(nbit=32,
                                       start_time=self.output_start_time(0))
            hdr = header_from_observation(obs, extra={"DUMP": "detected"})
            with open(path, "wb") as f:
                f.write(format_ascii_header(hdr))
        with open(path, "ab") as f:
            f.write(tfp.tobytes())

    # ---- sub-integration handling (TimeDivide/Subint equivalents) ----
    # division discovery lives in timing.timedivide.TimeDivide (sample-
    # exact boundaries); run() opens/flushes divisions per block span

    def _flush_division(self):
        if self._div_samples == 0:
            return
        if isinstance(self._profiles, tuple):
            prof = tuple(np.asarray(p) for p in self._profiles)
            hits = tuple(np.asarray(h) for h in self._hits)
        else:
            prof = np.asarray(self._profiles)
            hits = np.asarray(self._hits)
        self._subints.append(
            (prof, hits, self._div_first_time or self._first_out_time,
             self._div_samples / self.obs_out.rate)
        )
        self._div_first_time = None
        self._profiles = jax.tree_util.tree_map(jnp.zeros_like,
                                                self._profiles)
        self._hits = jax.tree_util.tree_map(jnp.zeros_like, self._hits)
        self._div_samples = 0.0

    def _finish(self) -> FoldResult:
        if not self._subints:
            self._flush_division()
        if self.config.minimum_integration_length > 0:
            # -m: the unloader discards too-short subints
            # (PhaseSeriesUnloader::set_minimum_integration_length)
            self._subints = [
                s for s in self._subints
                if s[3] >= self.config.minimum_integration_length]
        nsrc = len(self.predictors)
        multi = nsrc > 1

        def result(profs, hits, predictor, extras=None, nbin=None, dm=None,
                   label=None):
            return FoldResult(
                label=label,
                profiles=profs,
                hits=hits,
                epochs=[s[2] for s in self._subints],
                integration_length=np.array(
                    [s[3] for s in self._subints]),
                obs=self.obs_out,
                nbin=self.nbin if nbin is None else nbin,
                folding_period=predictor.period(self.obs_in.start_time),
                dispersion_measure=self.dm if dm is None else dm,
                cyclic_nlag=(self.cyclic_plan.nlag if self.cyclic_plan else 0),
                cyclic_mover=(self.cyclic_plan.mover
                              if self.cyclic_plan else 1),
                cyclic_npol=self.obs_stream.npol if self.cyclic_plan else 1,
                signal_path=self.signal_path(),
                digitizer_counts=(
                    state_counts_from_byte_counts(self._byte_counts,
                                                  self.obs_in.nbit)
                    if self.config.digitizer_stats and self.obs_in.nbit <= 8
                    and self._byte_counts.any() else None),
                extra_sources=extras,
                passband=self._passband,
                pdmp_stats=self._pdmp_stats,
                pdmp_nsamp=self._pdmp_nsamp,
                predictor=predictor,
                ephemeris=self.ephemeris,
            )

        if not multi:
            if self._subints:
                profs = np.stack([s[0] for s in self._subints])
                hits = np.stack([s[1] for s in self._subints])
            else:
                profs = np.zeros((0, self.obs_out.nchan, self.obs_out.npol,
                                  self.nbin))
                hits = np.zeros((0, self.obs_out.nchan, self.nbin))
            return result(profs, hits, self.predictor)

        # one FoldResult per pulsar, each with its own nbin/DM (the subint
        # tuples are ragged across sources, so stack per source)
        def src_stacks(s):
            if self._subints:
                return (np.stack([sub[0][s] for sub in self._subints]),
                        np.stack([sub[1][s] for sub in self._subints]))
            return (np.zeros((0, self.obs_out.nchan, self.obs_out.npol,
                              self.nbins[s])),
                    np.zeros((0, self.obs_out.nchan, self.nbins[s])))

        extras = []
        for s in range(1, nsrc):
            ps, hs = src_stacks(s)
            extras.append(result(
                ps, hs, self.predictors[s], nbin=self.nbins[s],
                dm=self.source_dms[s],
                label="nosk" if s == self._presk_index else None))
        p0, h0 = src_stacks(0)
        return result(p0, h0, self.predictors[0], extras=extras)


def load_to_fold(path: str, config: FoldConfig, **run_kw) -> FoldResult:
    """One-call convenience: open, construct, run (the dspsr app in a line)."""
    src = open_source(path)
    return FoldPipeline(src, config).run(**run_kw)
