#!/usr/bin/env python3
"""Bring-up check of dspsr_jax on one NVIDIA GPU, at the flagship widths.

The flagship is the reference benchmark's configuration
(``Benchmark/fold.csh``): 8-bit, dual-polarization, real-sampled CASPSR
baseband of J0437-4715 (1382 MHz centre, -400 MHz bandwidth,
800 Msamples/s), coherently dedispersed at DM 2.64 into 64 channels and
folded into 1024 phase bins.

    python chip_smoke.py [--seed N]     # phases A and B on one card
    python chip_smoke.py --four-cards   # the sharded path on four cards

Phase A writes a seeded DADA file with an injected, dispersed pulse train
and runs it through the ``dspsr`` and ``digifil`` entry points in this
process: the PSRFITS archive must show the pulse at its predicted phase,
and the SIGPROC filterbank must have the expected shape and size and show
the pulse too.  Phase B puts one flagship block (2^25 samples per
polarization) through the compiled device step and compares it with the
independent float64 model of the chain (``dspsr_jax.golden``).  With
``--four-cards`` only the sharded path runs: ``dspsr -t 4`` on a (4 time x
1 chan) mesh and on a (2 x 2) mesh, each compared with the one-card run of
the same file.

Any failure exits non-zero; on success the last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CENTRE, BANDWIDTH, RATE = 1382.0, -400.0, 800e6
PERIOD, DM = 0.005757451, 2.64
NCHAN, NBIN = 64, 1024
BLOCK = 1 << 25  # flagship block: samples per polarization
#: dispersion constant, s MHz^2 / (pc cm^-3) (the reference's 1/2.41e-4)
K_DM = 1.0 / 2.41e-4
PULSE_PHASE, PULSE_WIDTH = 0.3, 0.004  # turns at the band centre


def card_lines() -> list:
    """``nvidia-smi`` name and power limit of each card, read before JAX
    starts; no card is an error."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {e}")
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if r.returncode or not lines:
        raise SystemExit("chip_smoke: nvidia-smi reports no card")
    return lines


# ------------------------------------------------------------------ data

def band_frequency(f_bb: np.ndarray) -> np.ndarray:
    """Sky frequency (MHz) of real-sampled baseband frequency ``f_bb``
    (MHz): the band edge sits at baseband 0 and a negative bandwidth runs
    downwards (lower sideband)."""
    return CENTRE - BANDWIDTH / 2 + np.sign(BANDWIDTH) * f_bb


def write_flagship_dada(path: str, nsamp: int, seed: int) -> None:
    """Seeded CASPSR-format DADA file: Gaussian noise in each
    polarization whose power carries a pulse train (period PERIOD, phase
    PULSE_PHASE at the band centre), dispersed at DM by the textbook
    transfer function — each baseband component is delayed by
    K_DM * DM * (nu^-2 - nu_centre^-2)."""
    from dspsr_jax.io.dada import format_ascii_header, header_from_observation
    from dspsr_jax.observation import Observation, Signal
    from dspsr_jax.timing.mjd import MJD

    obs = Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=CENTRE,
        bandwidth=BANDWIDTH, rate=RATE,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.NYQUIST, source="J0437-4715", telescope="PKS",
        instrument="CASPSR").replace(ndat=nsamp)
    rng = np.random.default_rng(seed)
    phase = (np.arange(nsamp) / (RATE * PERIOD) - PULSE_PHASE) % 1.0
    dist = np.minimum(phase, 1.0 - phase)
    amp = np.sqrt(1.0 + 2.0 * np.exp(-0.5 * (dist / PULSE_WIDTH) ** 2))
    del phase, dist
    nu = band_frequency(np.fft.rfftfreq(nsamp, 1e6 / RATE))  # MHz
    disp = np.exp(1j * np.sign(BANDWIDTH) * 2 * np.pi * 1e6 * K_DM * DM
                  * (nu - CENTRE) ** 2 / (nu * CENTRE ** 2))
    del nu
    pols = []
    for _ in range(2):
        x = rng.standard_normal(nsamp, dtype=np.float32) * amp
        x = np.fft.irfft(np.fft.rfft(x) * disp, n=nsamp)
        pols.append(np.clip(np.round(x * 20.0), -128, 127).astype(np.int8))
        del x
    # CASPSR byte order: four consecutive samples of each polarization
    tp = np.stack(pols, axis=1).reshape(nsamp // 4, 4, 2)
    data = np.ascontiguousarray(tp.transpose(0, 2, 1)).view(np.uint8)
    with open(path, "wb") as f:
        f.write(format_ascii_header(header_from_observation(obs)))
        data.tofile(f)


def dedispersed_peak(prof: np.ndarray, freqs: np.ndarray, period: float):
    """Rotate each channel's profile [nchan, nbin] to the band centre,
    sum, and return (peak phase from the template fit, S/N)."""
    nbin = prof.shape[-1]
    k = np.fft.rfftfreq(nbin) * nbin
    tau = K_DM * DM * (freqs ** -2.0 - CENTRE ** -2.0)
    spec = np.fft.rfft(prof - prof.mean(axis=1, keepdims=True), axis=1)
    spec *= np.exp(2j * np.pi * k[None, :] * (tau / period)[:, None])
    total = np.fft.irfft(spec.sum(axis=0), n=nbin)
    x = np.arange(nbin) / nbin
    d = np.minimum(x, 1 - x)
    template = np.exp(-0.5 * (d / PULSE_WIDTH) ** 2)
    ccf = np.fft.irfft(np.fft.rfft(total) * np.conj(np.fft.rfft(template)),
                       n=nbin)
    off = total[np.abs(((x - PULSE_PHASE + 0.5) % 1) - 0.5) > 0.1]
    return int(np.argmax(ccf)) / nbin, (total.max() - off.mean()) / off.std()


def phase_error(got: float, want: float) -> float:
    return abs((got - want + 0.5) % 1.0 - 0.5)


# --------------------------------------------------------------- phase A

def phase_a(tmp: str, seed: int, card: str) -> None:
    from dspsr_jax.apps import digifil_app, dspsr_app
    from dspsr_jax.io.fits import read_bintable_column
    from dspsr_jax.io.sigproc import read_sigproc_header

    dada = os.path.join(tmp, "flagship.dada")
    t0 = time.perf_counter()
    write_flagship_dada(dada, 4 * BLOCK, seed)
    print(f"phase A: wrote {os.path.getsize(dada)} bytes "
          f"(4 flagship blocks) in {time.perf_counter() - t0:.1f} s")

    sf = os.path.join(tmp, "flagship.sf")
    t0 = time.perf_counter()
    rc = dspsr_app.main([dada, "-c", str(PERIOD), "-D", str(DM),
                         "-F", str(NCHAN), "-b", str(NBIN), "-O", sf, "-q"])
    wall = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(sf):
        raise RuntimeError(f"dspsr exit {rc}; archive written: "
                           f"{os.path.exists(sf)}")
    print(f"phase A: dspsr wall {wall:.1f} s on {card}")
    data = read_bintable_column(sf, "SUBINT", "DATA")
    scl = read_bintable_column(sf, "SUBINT", "DAT_SCL")
    offs = read_bintable_column(sf, "SUBINT", "DAT_OFFS")
    freqs = read_bintable_column(sf, "SUBINT", "DAT_FREQ")[0]
    q = np.asarray(data, np.float64).reshape(-1, 1, NCHAN, NBIN)[0, 0]
    prof = q * np.asarray(scl).reshape(-1, NCHAN)[0][:, None] \
        + np.asarray(offs).reshape(-1, NCHAN)[0][:, None]
    if not np.isfinite(prof).all():
        raise RuntimeError("archive profile is not finite")
    got, snr = dedispersed_peak(prof, np.asarray(freqs, np.float64), PERIOD)
    err = phase_error(got, PULSE_PHASE)
    print(f"phase A: archive pulse at phase {got:.5f} (injected "
          f"{PULSE_PHASE}), error {err * NBIN:.2f} bins, S/N {snr:.0f}")
    if err > 2.0 / NBIN or snr < 20:
        raise RuntimeError("pulse not recovered at its predicted phase")

    fil = os.path.join(tmp, "flagship.fil")
    t0 = time.perf_counter()
    rc = digifil_app.main([dada, "-F", str(NCHAN), "-o", fil, "-q"])
    wall = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(fil):
        raise RuntimeError(f"digifil exit {rc}")
    print(f"phase A: digifil wall {wall:.1f} s on {card}")
    hdr, hsize = read_sigproc_header(fil)
    nbytes = os.path.getsize(fil) - hsize
    nsamp = nbytes // NCHAN
    full = 4 * BLOCK // (2 * NCHAN)  # output samples in the whole file
    print(f"phase A: filterbank nchans {hdr.get('nchans')} nbits "
          f"{hdr.get('nbits')} nifs {hdr.get('nifs')} samples {nsamp} "
          f"(file holds {full})")
    if (hdr.get("nchans"), hdr.get("nbits"), hdr.get("nifs")) != (NCHAN, 8, 1) \
            or nbytes % NCHAN or not 0.9 * full <= nsamp <= full:
        raise RuntimeError("filterbank shape or size is wrong")
    # fold the filterbank at the pulsar period: the dispersed pulse sits at
    # each channel's delay; rotated to the centre it is at the injected phase
    d = np.fromfile(fil, np.uint8, offset=hsize)[: nsamp * NCHAN]
    d = d.reshape(nsamp, NCHAN).T.astype(np.float64)
    tsamp = float(hdr["tsamp"])
    ibin = ((np.arange(nsamp) * tsamp / PERIOD) % 1.0 * NBIN).astype(np.int64)
    fprof = np.stack([np.bincount(ibin, weights=d[c], minlength=NBIN)
                      for c in range(NCHAN)])
    fprof /= np.bincount(ibin, minlength=NBIN)[None, :]
    fch = float(hdr["fch1"]) + float(hdr["foff"]) * np.arange(NCHAN)
    got, snr = dedispersed_peak(fprof, fch, PERIOD)
    err = phase_error(got, PULSE_PHASE)
    # a critically sampled channel's centre is uncertain by half a
    # channel width, which moves the lowest channel's delay by up to
    lo = fch.min()
    amb = K_DM * DM * abs(lo ** -2 - (lo + abs(float(hdr["foff"])) / 2) ** -2)
    tol = amb / PERIOD + 2.0 / NBIN
    print(f"phase A: filterbank pulse at phase {got:.5f}, error "
          f"{err * NBIN:.2f} bins (tolerance {tol * NBIN:.1f}: 2 bins plus "
          f"half a channel of delay), S/N {snr:.0f}")
    if err > tol or snr < 10:
        raise RuntimeError("pulse not recovered in the filterbank")


# --------------------------------------------------------------- phase B

def flagship_pipeline(path: str):
    from dspsr_jax import golden
    from dspsr_jax.io.sources import open_source
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    cfg = FoldConfig(dispersion_measure=DM, nchan=NCHAN, nbin=NBIN,
                     folding_period=PERIOD, min_block_samples=BLOCK,
                     digitizer_stats=False)
    probe = FoldPipeline(open_source(path), cfg)
    # a period of a whole number of output samples per bin, offset half a
    # sample, so the float32 device phases and the float64 model's agree
    # on every sample's bin
    period, ref = golden.exact_fold(probe.obs_out.rate, NBIN, PERIOD)
    import dataclasses

    return FoldPipeline(open_source(path), dataclasses.replace(
        cfg, folding_period=period, reference_phase=ref))


def phase_b(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    from dspsr_jax import golden
    from dspsr_jax.models.load_to_fold import FoldPipeline
    from dspsr_jax.ops.fold import compute_anchors

    pipe = flagship_pipeline(os.path.join(tmp, "flagship.dada"))
    plan = pipe.fb_plan
    print(f"phase B: block {pipe.block_in_samples} samples/pol, "
          f"{pipe.npart} windows of {plan.nsamp_fft} real samples, "
          f"forward FFT {plan.n_fft}, inverse FFT {plan.freq_res} x "
          f"{NCHAN} channels, {pipe.out_per_block} output samples/channel")
    raw = pipe.source.read_samples(0, pipe.block_in_samples)
    seg = pipe.fold_plan.seg_len
    nuse = -(-pipe.out_per_block // seg) * seg
    phi0, dphi = compute_anchors(pipe.predictor, pipe.output_start_time(0),
                                 1.0 / pipe.obs_out.rate, nuse, seg)
    phi0 = (phi0 - pipe.config.reference_phase) % 1.0
    args = (jnp.zeros((NCHAN, 1, NBIN), jnp.float32),
            jnp.zeros((NCHAN, NBIN), jnp.float32),
            jnp.asarray(raw), jnp.asarray(phi0), jnp.asarray(dphi))
    t0 = time.perf_counter()
    compiled = FoldPipeline._step.lower(pipe, *args).compile()
    print(f"phase B: compile {time.perf_counter() - t0:.1f} s")
    print(f"phase B: memory_analysis {compiled.memory_analysis()}")
    prof, hits = compiled(*args)
    prof, hits = np.asarray(prof), np.asarray(hits)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"phase B: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    t0 = time.perf_counter()
    gold = golden.fold_block(pipe, raw, 0)
    print(f"phase B: float64 model {time.perf_counter() - t0:.1f} s")
    scale = np.abs(gold["profiles"]).max()
    err = np.abs(prof - gold["profiles"]).max() / scale
    herr = np.abs(hits - gold["hits"]).max()
    tol = 1e-4
    print(f"phase B: max |device - float64| / max profile = {err:.3e} "
          f"(tolerance {tol:g}: float32 FFTs and sums are good to ~1e-6 "
          f"of the profile; a float32 product leaking into TF32 keeps 10 "
          f"mantissa bits, ~1e-3); max hits difference {herr}")
    if not np.isfinite(prof).all() or err > tol or herr > 0:
        raise RuntimeError("device step disagrees with the float64 model")


# ----------------------------------------------------------- four cards

def four_cards(tmp: str, seed: int, card: str) -> None:
    from dspsr_jax.apps import dspsr_app
    from dspsr_jax.io.archive import load_archive
    from dspsr_jax.io.sources import DummySource
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline
    from dspsr_jax.observation import Observation, Signal
    from dspsr_jax.timing.mjd import MJD

    # size the file to whole superblocks of the CLI's block geometry (two
    # of the (4 x 1) mesh, four of the (2 x 2)), so the sharded and
    # one-card runs fold the same samples
    obs = Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=CENTRE,
        bandwidth=BANDWIDTH, rate=RATE, state=Signal.NYQUIST,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        instrument="CASPSR").replace(ndat=1 << 40)
    probe = FoldPipeline(DummySource(obs), FoldConfig(
        folding_period=PERIOD, dispersion_measure=DM, nchan=NCHAN,
        nbin=NBIN))
    nsamp = 2 * 4 * probe.stride_in_samples + probe.nsamp_overlap
    nsamp -= nsamp % 4
    dada = os.path.join(tmp, "four.dada")
    write_flagship_dada(dada, nsamp, seed)
    base = [dada, "-c", str(PERIOD), "-D", str(DM), "-F", str(NCHAN),
            "-b", str(NBIN), "-a", "npz", "-q"]
    runs = {"1 card": [], "4 x 1": ["-t", "4"],
            "2 x 2": ["-t", "2", "--chan-shards", "2"]}
    out = {}
    for tag, extra in runs.items():
        path = os.path.join(tmp, tag.replace(" ", "") + ".npz")
        t0 = time.perf_counter()
        rc = dspsr_app.main(base + extra + ["-O", path])
        if rc != 0:
            raise RuntimeError(f"dspsr {tag} exit {rc}")
        print(f"four cards: {tag} wall {time.perf_counter() - t0:.1f} s "
              f"on {card}")
        out[tag] = load_archive(path)
    ref = out["1 card"]
    for tag in ("4 x 1", "2 x 2"):
        a = out[tag]
        scale = np.abs(ref["profiles"]).max()
        err = np.abs(a["profiles"] - ref["profiles"]).max() / scale
        herr = np.abs(a["hits"] - ref["hits"]).max()
        print(f"four cards: ({tag}) max |sharded - 1 card| / max profile "
              f"= {err:.3e}, max hits difference {herr}")
        if not err < 1e-4 or herr > 1e-3:
            raise RuntimeError(f"({tag}) disagrees with the one-card run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    cards = card_lines()
    for ln in cards:
        print(ln)
    card = cards[0]

    import jax

    jax.config.update("jax_platforms", "cuda")
    try:
        devices = jax.devices()
    except (RuntimeError, AssertionError) as e:  # no CUDA backend
        raise SystemExit(f"chip_smoke: no GPU: {type(e).__name__}: {e}")
    want = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        raise SystemExit(f"chip_smoke: need {want} GPU(s), have {devices}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four_cards:
            four_cards(tmp, args.seed, card)
        else:
            t0 = time.perf_counter()
            phase_a(tmp, args.seed, card)
            print(f"phase A: {time.perf_counter() - t0:.1f} wall s on {card}")
            phase_b(tmp)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
