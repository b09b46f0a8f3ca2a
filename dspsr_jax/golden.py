"""Independent float64 numpy model of the fold chain (the test reference).

Re-implements, block by block, unpack -> frame -> FFT -> response (scalar
chirp or Jones matrix) [-> RFI zap] -> inverse FFT -> detection [-> cyclic
lag products, fourth moments] -> SK excision -> fold, directly from the
conventions the op docstrings document (and ultimately from the
reference's C++: ``Filterbank.C``, ``Convolution.C``, ``Detection.C``,
``SpectralKurtosis.C``, ``Fold.C``).  It shares no device code with
:class:`~dspsr_jax.models.load_to_fold.FoldPipeline`; it reads only the
pipeline's resolved geometry and host-side constants (BitTable and JA98
level tables, the dedispersion chirp, the calibration Jones matrices, the
apodization window, the predictor and the output epoch of each block).

Phases are evaluated in float64 per sample from the predictor (the device
extrapolates float32 segment anchors), so a sample that lies within float32
rounding of a bin edge may land in a neighbouring bin on one side only.
Tests avoid that by folding at a period of a whole number of output
samples per bin with a half-sample phase offset (:func:`exact_fold`).
"""

from __future__ import annotations

import numpy as np

from .observation import Signal
from .unpack.bittable import BitTable, CodeType


def exact_fold(rate_out: float, nbin: int, approx_period: float):
    """(period, reference_phase) for which every output sample lies half a
    sample away from a phase-bin edge: the period spans a whole number of
    output samples per bin, and the phase is offset by half a sample."""
    k = max(1, round(approx_period * rate_out / nbin))
    return nbin * k / rate_out, (-0.5 / (nbin * k)) % 1.0


# ---------------------------------------------------------------- unpack

def _codes(raw: np.ndarray, nbit: int) -> np.ndarray:
    """Per-sample integer codes, most significant field first."""
    raw = np.asarray(raw, np.uint8)
    if nbit == 8:
        return raw.astype(np.int64)
    per = 8 // nbit
    mask = (1 << nbit) - 1
    fields = [(raw >> (nbit * (per - 1 - k))) & mask for k in range(per)]
    return np.stack(fields, axis=1).reshape(-1).astype(np.int64)


def unpack(pipe, raw: np.ndarray):
    """Raw block bytes -> (x [nchan, npol, ndat] float64 or complex128,
    weights [nchan, nweights] or None)."""
    obs = pipe.obs_in
    up = pipe.unpack_plan
    nchan, npol, ndim = obs.nchan, obs.npol, obs.ndim
    nd = nchan * npol * ndim
    w = None
    if obs.nbit == 32:
        v = np.frombuffer(np.asarray(raw, np.uint8).tobytes(),
                          "<f4").astype(np.float64)
    else:
        raw = np.asarray(raw, np.uint8)
        if up.layout == "caspsr":
            # four consecutive samples per polarization
            raw = raw.reshape(-1, npol, 4).transpose(0, 2, 1).reshape(-1)
        codes = _codes(raw, obs.nbit)
        if up.twobit is not None:
            v, w = _ja98(codes, up.twobit, nchan, npol * ndim,
                         up.ndat_per_weight)
        else:
            kind = (CodeType.TWOS_COMPLEMENT if up.twos_complement
                    else CodeType.OFFSET_BINARY)
            v = BitTable(obs.nbit, kind).values.astype(np.float64)[codes]
    tfp = v.reshape(-1, nchan, npol, ndim)
    ndat = len(raw) * 8 // (obs.nbit * nd) if obs.nbit != 32 else tfp.shape[0]
    if tfp.shape[0] < ndat:
        # JA98 unpacks whole weight spans only; the tail reads as zeros
        tfp = np.concatenate(
            [tfp, np.zeros((ndat - tfp.shape[0], nchan, npol, ndim))])
    x = tfp.transpose(1, 2, 0, 3)
    x = x[..., 0] + 1j * x[..., 1] if ndim == 2 else x[..., 0]
    return x, w


def _ja98(codes, tb, nchan, ndig_per_chan, npw):
    """Jenet & Anderson (1998) dynamic 2-bit levels per ``npw`` samples of
    each digitizer stream, and the excision weight of each span (a span
    is bad where any of the channel's streams is)."""
    nd = nchan * ndig_per_chan
    c = codes.reshape(-1, nd)
    nw = c.shape[0] // npw
    c = c[: nw * npw].reshape(nw, npw, nd)
    low = (c == 1) | (c == 2)
    nlow = low.sum(axis=1)  # [nw, nd]
    lo = tb.level_tables[0].astype(np.float64)[nlow][:, None, :]
    hi = tb.level_tables[1].astype(np.float64)[nlow][:, None, :]
    sign = np.where(c >= 2, 1.0, -1.0)
    v = sign * np.where(low, lo, hi)
    wd = tb.weight_table[nlow].reshape(nw, nchan, ndig_per_chan)
    return v.reshape(-1), wd.min(axis=2).T


# ------------------------------------------------------------ geometry

def _geometry(pipe):
    if pipe.fb_plan is not None:
        p = pipe.fb_plan
        return p, p.nkeep, p.nchan_subband, p.freq_res
    if pipe.conv_plan is not None:
        p = pipe.conv_plan
        return p, p.nkeep_c, 1, p.n_fft
    return None, 0, 1, 0


def _window_weights(pipe, w, ndat_out):
    """Per-output-sample weights [nchan_out, ndat_out]: an output sample
    is bad if any input sample of the FFT window that produced it was
    (WeightedTimeSeries::convolve_weights)."""
    nchan_out = pipe.obs_out.nchan
    if w is None or w.shape[1] == 0:
        return np.ones((nchan_out, ndat_out))
    plan, nkeep, nsub, _ = _geometry(pipe)
    npw = pipe.unpack_plan.ndat_per_weight
    nw = w.shape[1]
    if plan is None:
        per = np.repeat(w, npw, axis=1)[:, :ndat_out]
    else:
        cols = []
        for p in range(pipe.npart):
            a = min(p * plan.nsamp_step // npw, nw - 1)
            b = max(min((p * plan.nsamp_step + plan.nsamp_fft + npw - 1)
                        // npw, nw), a + 1)
            cols.append(np.repeat(w[:, a:b].min(axis=1)[:, None], nkeep, 1))
        per = np.concatenate(cols, axis=1)[:, :ndat_out]
    return np.repeat(per, nchan_out // per.shape[0], axis=0)


def _frames(x, plan, npart, window):
    """[..., ndat] -> [npart, ..., nsamp_fft] overlap-save windows."""
    n = plan.nsamp_fft
    need = (npart - 1) * plan.nsamp_step + n
    if x.shape[-1] < need:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, need - x.shape[-1])]
        x = np.pad(x, pad)
    f = np.stack([x[..., p * plan.nsamp_step: p * plan.nsamp_step + n]
                  for p in range(npart)])
    return f * window if window is not None else f


def _natural_spectra(frames, real_input):
    """Forward FFT in natural (ascending frequency) bin order: real input
    keeps rfft bins 0..N-1; complex input is fftshift-ed about DC."""
    if real_input:
        return np.fft.rfft(frames, axis=-1)[..., : frames.shape[-1] // 2]
    return np.fft.fftshift(np.fft.fft(frames, axis=-1), axes=-1)


def _median_filter(a, width):
    """Running median over the last axis, edge-replicated."""
    half = width // 2
    pad = [(0, 0)] * (a.ndim - 1) + [(half, half)]
    v = np.lib.stride_tricks.sliding_window_view(
        np.pad(a, pad, mode="edge"), width, axis=-1)
    return np.median(v, axis=-1)


def _rfi_mask(power, width, threshold):
    """Keep-mask of bins whose power is at most ``threshold`` times the
    running median of the band (ops.rfifilter semantics)."""
    med = _median_filter(power, width)
    return (power <= threshold * np.maximum(med, 1e-30)).astype(np.float64)


def channelize(pipe, x):
    """Voltages -> (y [nchan_out, npol, ndat_out] complex, passband or
    None): the convolving filterbank, the nsub == 1 overlap-save
    convolution, or (no FFT stage) the input itself."""
    cfg = pipe.config
    plan, nkeep, nsub, fr = _geometry(pipe)
    if plan is None:
        return x, None
    window = None
    if cfg.fft_window:
        from .ops.apodization import WindowType, build_window

        window = build_window(WindowType(cfg.fft_window),
                              plan.nsamp_fft).astype(np.float64)
    npart = pipe.npart
    spec = _natural_spectra(_frames(x, plan, npart, window), plan.real_input)
    # spec: [npart, nchan_in, npol, nsub * fr]
    nchan_in, npol = spec.shape[1], spec.shape[2]
    spec = spec.reshape(npart, nchan_in, npol, nsub, fr)
    passband = None
    if cfg.passband:
        pb = (np.abs(spec) ** 2).sum(axis=0)  # [nchan_in, npol, nsub, fr]
        passband = pb.transpose(0, 2, 1, 3).reshape(nchan_in * nsub, npol, fr)
    rfi = (cfg.rfi_median_width, cfg.rfi_threshold) if cfg.rfi_filter \
        else None
    if pipe.fb_plan is not None:
        if pipe.kernel is not None:
            chirp = pipe.kernel.phasors.astype(np.complex128)
            spec = spec * chirp.reshape(nchan_in, 1, nsub, fr)
        if rfi is not None:
            # the median runs across each input channel's whole band,
            # after the response (apply_response_chunked)
            bp = (np.abs(spec) ** 2).mean(axis=0)
            bp = bp.reshape(nchan_in, npol, nsub * fr)
            spec = spec * _rfi_mask(bp, *rfi).reshape(nchan_in, npol, nsub, fr)
        if fr == 1:
            sub = spec
        else:
            sub = np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1)
        kept = sub[..., plan.nfilt_pos: plan.nfilt_pos + nkeep]
    else:
        spec = spec[:, :, :, 0]  # [npart, nchan, npol, n_fft]
        if rfi is not None:
            # zapped from the block's own pre-response spectra per
            # (channel, polarization)
            spec = spec * _rfi_mask((np.abs(spec) ** 2).mean(axis=0), *rfi)
        if pipe.jones_response is not None:
            j = pipe.jones_response.astype(np.complex128)  # [nchan, n, 2, 2]
            p, q = spec[:, :, 0], spec[:, :, 1]
            spec = np.stack([j[..., 0, 0] * p + j[..., 0, 1] * q,
                             j[..., 1, 0] * p + j[..., 1, 1] * q], axis=2)
        else:
            chirp = pipe.kernel.phasors.astype(np.complex128)
            spec = spec * chirp[:, None, :]
        if not plan.real_input:
            spec = np.fft.ifftshift(spec, axes=-1)
        sub = np.fft.ifft(spec, axis=-1)[..., None, :]
        kept = sub[..., plan.nfilt_pos: plan.nfilt_pos + nkeep]
    # kept: [npart, nchan_in, npol, nsub, nkeep] -> [nchan_out, npol, T]
    y = kept.transpose(1, 3, 2, 0, 4).reshape(nchan_in * nsub, npol,
                                               npart * nkeep)
    return y, passband


# ------------------------------------------------------------- detection

def detect(y, state: Signal):
    """Detection.C:42-66 conventions (stokes_detect.ic, cross_detect.ic)."""
    p = y[:, 0]
    pp = np.abs(p) ** 2
    if state == Signal.INTENSITY or state == Signal.NTHPOWER:
        tot = (pp + np.abs(y[:, 1]) ** 2) if y.shape[1] > 1 else pp
        tot = tot[:, None]
        return tot * tot if state == Signal.NTHPOWER else tot
    if state == Signal.PP:
        return pp[:, None]
    qq = np.abs(y[:, 1]) ** 2
    if state == Signal.QQ:
        return qq[:, None]
    if state == Signal.PPQQ:
        return np.stack([pp, qq], axis=1)
    cross = np.conj(p) * y[:, 1]  # p* q
    if state == Signal.COHERENCE:
        return np.stack([pp, qq, cross.real, cross.imag], axis=1)
    if state == Signal.STOKES:
        return np.stack([pp + qq, pp - qq, 2 * cross.real, 2 * cross.imag],
                        axis=1)
    raise ValueError(state)


def lag_planes(y, nlag):
    """Cyclic lag products c_l[t] = y[t+l] conj(y[t]) as real planes
    ((ipol*nlag + l)*2 + is_imag) (CyclicFold)."""
    n = y.shape[-1] - nlag + 1
    planes = []
    for ipol in range(y.shape[1]):
        for lag in range(nlag):
            c = y[:, ipol, lag: lag + n] * np.conj(y[:, ipol, :n])
            planes += [c.real, c.imag]
    return np.stack(planes, axis=1)


def fourth_moment(s):
    """Stokes S -> [S, S_i S_j for i <= j] (FourthMoment.C)."""
    prods = [s[:, i] * s[:, j] for i in range(4) for j in range(i, 4)]
    return np.concatenate([s, np.stack(prods, axis=1)], axis=1)


def sk_weights(power, plan, ndat):
    """Spectral-kurtosis keep-weights [nchan, ndat] from per-polarization
    power [nchan, npol, ndat] (Nita & Gary 2010; SKDetector cell, tscr
    and fscr rounds; a cell is zapped if any polarization trips)."""
    nchan, npol = power.shape[:2]
    m = plan.M
    nblk = ndat // m
    cells = power[:, :, : nblk * m].reshape(nchan, npol, nblk, m)

    def sk(s1, s2, n):
        return (n + 1) / (n - 1) * (n * s2 / np.maximum(s1 * s1, 1e-30) - 1)

    s1, s2 = cells.sum(-1), (cells * cells).sum(-1)
    w = np.ones((nchan, nblk))
    lo, hi = plan.thresholds()
    w *= ((sk(s1, s2, m) > lo) & (sk(s1, s2, m) < hi)).all(axis=1)
    if plan.detect_tscr and nblk > 1:
        lo_t, hi_t = plan.thresholds(m * nblk)
        v = sk(s1.sum(-1), s2.sum(-1), m * nblk)
        w *= ((v > lo_t) & (v < hi_t)).all(axis=1)[:, None]
    if plan.detect_fscr and nchan > 1:
        n = m * nchan
        v = sk(s1.sum(0), s2.sum(0), n)  # [npol, nblk]
        one = np.sqrt(4.0 / n)
        good = ((v > 1 - plan.std_devs * one)
                & (v < 1 + plan.std_devs * one)).all(axis=0)
        w *= good[None, :]
    if plan.chan_start or plan.chan_end:
        end = plan.chan_end or nchan
        ix = np.arange(nchan)
        w[(ix < plan.chan_start) | (ix >= end)] = 1.0
    out = np.ones((nchan, ndat))
    out[:, : nblk * m] = np.repeat(w, m, axis=1)
    return out


# ----------------------------------------------------------------- fold

def fold(d, weights, phase, nbin):
    """Phase-bin accumulation (Fold.C:744-873): ``phase`` is each output
    sample's fractional turn; returns (profiles [nchan, npol, nbin], hits
    [nchan, nbin])."""
    nchan, npol, n = d.shape
    ibin = np.minimum((phase * nbin).astype(np.int64), nbin - 1)
    prof = np.zeros((nchan, npol, nbin))
    hits = np.zeros((nchan, nbin))
    for c in range(nchan):
        hits[c] = np.bincount(ibin, weights=weights[c], minlength=nbin)
        for p in range(npol):
            prof[c, p] = np.bincount(ibin, weights=d[c, p] * weights[c],
                                     minlength=nbin)
    return prof, hits


def block_phase(pipe, start_sample: int, n: int) -> np.ndarray:
    """float64 fractional turn of each of ``n`` output samples of the block
    that starts at input sample ``start_sample``."""
    t0 = pipe.output_start_time(start_sample)
    period = pipe.predictor.period(t0)
    ph = (pipe.predictor.fracturns(t0) - pipe.config.reference_phase
          + np.arange(n) / (pipe.obs_out.rate * period))
    return ph - np.floor(ph)


def fold_block(pipe, raw: np.ndarray, start_sample: int) -> dict:
    """One block through the whole chain.  Returns ``profiles``, ``hits``,
    the detected stream ``detected`` [nchan, npol, ndat] (the dump tap),
    and ``passband`` and ``moments`` when the configuration asks for
    them."""
    cfg = pipe.config
    x, w = unpack(pipe, raw)
    y, passband = channelize(pipe, x)
    if np.isrealobj(y):
        y = y.astype(np.complex128)
    if pipe.cyclic_plan is not None:
        d = lag_planes(y, pipe.cyclic_plan.nlag)
    else:
        d = detect(y, pipe.det_state)
    if cfg.fourth_moment:
        d = fourth_moment(d)
    n = d.shape[-1]
    weights = _window_weights(pipe, w, n)
    if pipe.sk_plan is not None:
        weights = weights * sk_weights(np.abs(y) ** 2, pipe.sk_plan, n)
    prof, hits = fold(d, weights, block_phase(pipe, start_sample, n),
                      pipe.nbin)
    out = dict(profiles=prof, hits=hits, detected=d, passband=passband)
    if cfg.pdmp_stats:
        out["moments"] = np.stack([(d ** k).sum(axis=2) for k in (1, 2, 3, 4)],
                                  axis=-1)
    return out


def fold_run(pipe, nblocks: int) -> dict:
    """Accumulate :func:`fold_block` over the pipeline's first ``nblocks``
    blocks of its source (one sub-integration)."""
    acc = {}
    start = 0
    for _ in range(nblocks):
        raw = pipe.source.read_samples(start, pipe.block_in_samples)
        b = fold_block(pipe, raw, start)
        for k, v in b.items():
            if v is None:
                continue
            if k == "detected":
                acc.setdefault(k, []).append(v)
            else:
                acc[k] = acc[k] + v if k in acc else v
        start += pipe.stride_in_samples
    if "detected" in acc:
        acc["detected"] = np.concatenate(acc["detected"], axis=-1)
    return acc
