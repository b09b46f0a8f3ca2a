"""dspsr-jax: fold-mode pulsar processing CLI.

Equivalent of the reference ``dspsr`` application
(``Signal/Pulsar/dspsr.C:207-798``; option letters kept where they map
cleanly).  Builds a FoldConfig, runs the pipeline, writes archives.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dspsr-jax",
        description="Fold raw baseband into phase-resolved archives "
        "(JAX dspsr equivalent)",
    )
    p.add_argument("files", nargs="+", help="input data file(s)")
    # dispersion / channelization (dspsr.C option letters)
    p.add_argument("-D", "--dm", type=float, default=None,
                   help="dispersion measure (pc cm^-3); default from ephemeris")
    p.add_argument("-F", "--nchan", type=int, default=1,
                   help="output filterbank channels (convolving filterbank)")
    p.add_argument("-x", "--freq-res", default=None, metavar="nfft|minX",
                   help="spectral resolution (FFT length per channel): a "
                        "number, or 'min' / 'minXu' for u times the "
                        "minimum valid transform (reference -x; a ':D' "
                        "nsmear suffix is ignored on this runtime)")
    p.add_argument("--incoherent", action="store_true",
                   help="disable coherent dedispersion")
    # folding
    p.add_argument("-b", "--nbin", type=int, default=0, help="phase bins")
    p.add_argument("-c", "--period", type=float, default=None,
                   help="fold at constant period (seconds)")
    p.add_argument("--cepoch", type=float, default=None, metavar="MJD",
                   help="reference epoch for phase=0 when -c is used "
                        "(reference --cepoch)")
    p.add_argument("-w", "--predictors-file", default=None, metavar="FILE",
                   help="file listing additional predictors/periods to "
                        "fold, one per line (reference -w)")
    p.add_argument("-P", "--polyco", default=None, help="TEMPO polyco file")
    p.add_argument("-E", "--ephemeris", default=None, help="par file")
    p.add_argument("--fft-bench", action="store_true",
                   help="choose FFT length from measured backend timings "
                        "(reference OptimalFFT)")
    p.add_argument("--poln-cal", default=None, metavar="CAL",
                   help="Jones calibration solution (or cal database) for "
                        "matrix convolution (reference PolnCalibration)")
    p.add_argument("-p", "--phase", type=float, default=0.0,
                   help="reference phase of bin zero")
    p.add_argument("-X", "--pulsar", action="append", default=[],
                   metavar="SPEC",
                   help="fold an ADDITIONAL source in the same pass: a "
                        "period in seconds, a polyco, or a .par file "
                        "(repeatable; reference multi-pulsar folding)")
    p.add_argument("--fft-window", default=None,
                   choices=["none", "hanning", "welch", "parzen", "tukey"],
                   help="apodize each FFT window (reference --fft-window)")
    p.add_argument("--passband", action="store_true",
                   help="integrate the bandpass and attach it to the archive")
    p.add_argument("-Y", "--pdmp", action="store_true",
                   help="output pdmp extras: running moments of the "
                        "detected stream (reference -Y / Stats op)")
    def _archive_class(s):
        v = s.lower()
        if v not in ("psrfits", "npz"):
            raise argparse.ArgumentTypeError(
                f"unknown archive class {s!r}: this runtime writes "
                "psrfits or npz (reference -a validates against the "
                "Pulsar::Archive agent registry)")
        return v

    p.add_argument("-a", "--archive", type=_archive_class, default=None,
                   metavar="CLASS",
                   help="output archive class: psrfits | npz "
                        "(default: from -O extension, else npz)")
    p.add_argument("-e", "--extension", default=None,
                   help="output filename extension (reference -e)")
    p.add_argument("-N", "--name", default=None,
                   help="override the source name (reference -N)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="override an Observation attribute before "
                        "processing (reference --set / ObservationChange)")
    # source metadata overrides (reference Source/Clock option groups)
    p.add_argument("-B", "--bandwidth", type=float, default=None,
                   help="set the bandwidth in MHz (reference -B)")
    p.add_argument("-f", "--frequency", type=float, default=None,
                   help="set the centre frequency in MHz (reference -f)")
    p.add_argument("-k", "--telescope", default=None,
                   help="set the telescope name (reference -k)")
    p.add_argument("-m", "--mjd", default=None, metavar="MJD",
                   help="set the start MJD of the observation "
                        "(reference -m MJD)")
    p.add_argument("-C", "--offset-clock", type=float, default=0.0,
                   metavar="SECONDS",
                   help="adjust the clock by offset seconds (reference -C)")
    # 2-bit excision options (reference -2 code, ExcisionUnpacker)
    p.add_argument("-2", "--excision", default=None, metavar="CODE",
                   dest="excision",
                   help="2-bit excision options: tokens n<samples> (window "
                        "length) and c<sigma> (cutoff), e.g. -2 n512:c3.5 "
                        "(reference -2 / TwoBitCorrection)")
    # detection
    p.add_argument("-d", "--npol", type=int, default=1,
                   choices=[1, 2, 3, 4],
                   help="output polns: 1=I 2=PPQQ 3=(PP+QQ)^2 4=Stokes "
                        "(reference -d)")
    p.add_argument("--Lmin", "--minimum-integration",
                   dest="minimum_integration", type=float,
                   default=0.0, metavar="SECONDS",
                   help="discard subints shorter than this (reference "
                        "-Lmin -> PhaseSeriesUnloader minimum integration "
                        "length)")
    p.add_argument("-j", "--job", action="append", default=[],
                   metavar="CMD",
                   help="psrsh command run on each written archive "
                        "(reference -j; repeatable)")
    p.add_argument("-J", "--post-script", default=None, metavar="SCRIPT",
                   help="run on each written archive: 'psrsh SCRIPT file' "
                        "when psrsh is installed, else SCRIPT is executed "
                        "with the archive path (reference -J psrsh hook, "
                        "Archiver post-processing script)")
    p.add_argument("-R", "--zap-rfi", action="store_true",
                   help="apply the time-variable narrow-band RFI filter "
                        "(reference -R -> RFIFilter x ResponseProduct; "
                        "each block is zapped with the mask from its own "
                        "median bandpass)")
    def _odd_width(s):
        v = int(s)
        if v < 3 or v % 2 == 0:
            raise argparse.ArgumentTypeError(
                "median window width must be odd and >= 3")
        return v

    p.add_argument("--rfi-median", type=_odd_width, default=21,
                   metavar="BINS",
                   help="RFI filter: median window width across frequency "
                        "(odd, >= 3)")
    p.add_argument("--rfi-threshold", type=float, default=4.0,
                   help="RFI filter: zap bins above this multiple of the "
                        "local median bandpass")
    p.add_argument("--rfi-same-block", action="store_true",
                   help="accepted; -R always zaps each block with the mask "
                        "measured on that same block (the only mode)")
    p.add_argument("--detect", default=None,
                   choices=["intensity", "ppqq", "pp", "qq", "coherence",
                            "stokes", "nthpower"],
                   help="explicit detection state (reference Detection "
                        "states incl. 4-pol coherence products, "
                        "Detection.C:42-66); overrides -d")
    # phase-locked filterbank (reference -G nbin, dspsr.C:345)
    p.add_argument("-G", "--plfb-bin", type=int, default=0,
                   help="phase-locked filterbank: phase bins (enables PLFB mode)")
    p.add_argument("--plfb-chan", type=int, default=0,
                   help="phase-locked filterbank: channels per input channel "
                        "(default: auto from period)")
    # subints
    p.add_argument("-L", "--subint", type=float, default=0.0,
                   help="subintegration length (seconds)")
    p.add_argument("--turns", type=int, default=0,
                   help="subintegration length in pulse turns")
    p.add_argument("-s", "--single-pulse", action="store_true",
                   help="create single-pulse subintegrations "
                        "(= --turns 1; reference -s)")
    p.add_argument("-y", "--fractional-pulses", action="store_true",
                   help="output partially completed integrations: keep "
                        "the partial first pulse of turn divisions "
                        "(reference -y -> TimeDivide fractional_pulses)")
    p.add_argument("--Lepoch", type=float, default=None, metavar="MJD",
                   help="start time of the first sub-integration "
                        "(reference -Lepoch; default: integer -L aligns "
                        "to UTC multiples of the length in the day)")
    p.add_argument("-A", "--single-archive", action="store_true",
                   help="output a single archive with multiple "
                        "integrations (reference -A; this is also the "
                        "default here unless --nsub is given)")
    p.add_argument("--nsub", type=int, default=0, metavar="N",
                   help="output archives with N integrations each "
                        "(reference --nsub)")
    # time selection
    p.add_argument("-S", "--seek", type=float, default=0.0,
                   help="skip this many seconds of input (reference -S)")
    p.add_argument("-K", "--interchannel-align", action="store_true",
                   help="remove inter-channel dispersion delays in the chirp")
    p.add_argument("-4", "--fourth-moment", dest="fourth_moment",
                   action="store_true",
                   help="fold fourth-order moments (requires -d 4)")
    p.add_argument("--cyclic", type=int, default=0, metavar="N",
                   help="cyclic spectroscopy with N channels (CyclicFold)")
    p.add_argument("--cyclic-mover", type=int, default=1,
                   help="cyclic oversampling factor")
    p.add_argument("--dump", default=None, metavar="FILE",
                   help="tap the detected stream to a float32 DADA file")
    p.add_argument("-U", "--ram-mb", default=None, metavar="MB|minX",
                   help="block sample budget from a RAM figure in MB, or "
                        "'min' / 'minXu' for u times the minimum block "
                        "(one FFT window; reference -U)")
    p.add_argument("--minram", type=float, default=None, metavar="MB",
                   help="minimum RAM usage in MB (block-size floor; "
                        "reference -minram)")
    p.add_argument("-T", "--total", type=float, default=None,
                   help="process only this many seconds")
    # RFI
    p.add_argument("--skz", action="store_true", help="spectral kurtosis zap")
    p.add_argument("--skzm", type=int, default=128, help="SK cell size M")
    p.add_argument("--skzs", type=int, default=3, help="SK sigma threshold")
    p.add_argument("--skz_no_tscr", action="store_true")
    p.add_argument("--skz_no_fscr", action="store_true")
    p.add_argument("--skz_start", type=int, default=0,
                   help="first channel where signal is expected")
    p.add_argument("--skz_end", type=int, default=0,
                   help="last channel where signal is expected (exclusive)")
    # reference options accepted for argv compatibility; each prints a
    # note when used (VERDICT r4 #9: no silent no-ops).  The right-hand
    # column of the PARITY.md option audit documents the reasons.
    p.add_argument("--order", default=None, metavar="BOOL",
                   help="accepted; data ordering is always FPT on this "
                        "runtime (reference -order)")
    p.add_argument("--asynch-fold", action="store_true",
                   help="accepted; jax async dispatch already overlaps "
                        "host and device work (reference -asynch-fold)")
    p.add_argument("--skzn", type=int, default=None, metavar="N",
                   help="accepted; SK runs inside the device program, no "
                        "CPU thread pool exists (reference -skzn)")
    p.add_argument("--noskz_too", action="store_true",
                   help="also fold the un-zapped (pre-SK) stream and "
                        "write it as <output>.nosk (reference -noskz_too "
                        "-> presk_fold fork + '.nosk' Archiver)")
    p.add_argument("--skz_no_ft", action="store_true",
                   help="accepted with a warning; no despeckeler is "
                        "implemented (reference -skz_no_ft)")
    p.add_argument("--sk_fold", action="store_true",
                   help="accepted with a warning; the SKFilterbank output "
                        "fold is not implemented (reference -sk_fold)")
    p.add_argument("-n", "--ndim", type=int, default=None,
                   help="accepted with a warning; the archive keeps npol "
                        "from -d (reference experimental -n)")
    p.add_argument("--no_dyn", action="store_true",
                   help="disable dynamic archive extensions (digitizer "
                        "histograms and passband; reference -no_dyn)")
    # engine
    p.add_argument("--block-parts", type=int, default=4,
                   help="FFT windows per device block")
    p.add_argument("-t", "--threads", type=int, default=1, metavar="N",
                   help="shard time blocks over N devices (LoadToFoldN; "
                        "pair with --chan-shards for channel parallelism)")
    p.add_argument("--chan-shards", type=int, default=1,
                   help="channel-parallel mesh axis size (MPITrans role)")
    p.add_argument("-O", "--output", default=None,
                   help="output archive filename (default: <source>_<MJD>.npz)")
    p.add_argument("--repeat", type=int, nargs="?", const=0, default=None,
                   metavar="N",
                   help="soak mode: reprocess the input N times (no N = "
                        "forever; reference --repeat, SingleThread.C:456-487)")
    p.add_argument("-r", "--report", action="store_true",
                   help="print per-stage timing report")
    p.add_argument("--header", nargs="+", default=None, metavar="KEY=VAL",
                   help="treat input as headerless raw data described by "
                        "these keys (CommandLineHeader equivalent)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def coerce_set_value(obs, key: str, value: str):
    """Coerce a ``--set KEY=VAL`` string from the DECLARED dataclass field
    type of ``obs`` (reference TextInterface attribute editor,
    ``Kernel/Classes/ObservationInterface.C``).  The declared type — not the
    current value, which may be None — decides: ``Optional[X]`` unwraps to
    X; bools parse true/false/1/0; enum-valued fields (Signal, Basis) coerce
    through the current value's type."""
    import dataclasses

    cur = getattr(obs, key)  # raise on unknown key
    ftypes = {f.name: f.type for f in dataclasses.fields(type(obs))}
    ft = ftypes.get(key)
    if not isinstance(ft, str):  # non-PEP-563 environments
        ft = getattr(ft, "__name__", str(ft))
    ft = ft.replace("Optional[", "").rstrip("]")
    py = {"int": int, "float": float, "bool": bool,
          "str": str}.get(ft.split("[")[0])
    if py is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if py in (int, float):
        return py(value)
    if py is str:
        return value
    if cur is not None and not isinstance(cur, str):
        return type(cur)(value)  # enums (Signal, Basis) et al.
    return value


def run_post_script(script: str, archive_path: str, quiet: bool) -> None:
    """The reference's -J hook: run a psrsh script on each freshly written
    archive (``Signal/Pulsar/Archiver.C`` psrsh post-processing).  When no
    psrsh exists in this environment, SCRIPT itself is executed with the
    archive path (any executable post-processor)."""
    import shutil
    import subprocess

    psrsh = shutil.which("psrsh")
    cmd = [psrsh, script, archive_path] if psrsh else [script, archive_path]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0 and not quiet:
            import sys as _sys

            print(f"dspsr-jax: -J {script} failed ({r.returncode}): "
                  f"{r.stderr.strip()[:200]}", file=_sys.stderr)
    except (OSError, subprocess.TimeoutExpired) as e:
        if not quiet:
            import sys as _sys

            print(f"dspsr-jax: -J {script}: {e}", file=_sys.stderr)


def _run_jobs(args, path):
    """-j inline psrsh commands + -J script on a written archive."""
    if args.job:
        import tempfile, os
        with tempfile.NamedTemporaryFile("w", suffix=".psh",
                                         delete=False) as f:
            f.write("\n".join(args.job) + "\n")
            tmp = f.name
        try:
            run_post_script(tmp, path, args.quiet)
        finally:
            os.unlink(tmp)
    if args.post_script:
        run_post_script(args.post_script, path, args.quiet)


def _slice_result(res, lo, hi):
    """Subint range [lo, hi) of a FoldResult (reference --nsub: archives
    with N integrations each)."""
    import dataclasses

    return dataclasses.replace(
        res,
        profiles=res.profiles[lo:hi],
        hits=res.hits[lo:hi],
        epochs=res.epochs[lo:hi],
        integration_length=res.integration_length[lo:hi],
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.platform import enable_compilation_cache
    enable_compilation_cache()
    from ..models.load_to_fold import FoldConfig, FoldPipeline
    from ..io.sources import open_source, MultiFile
    from ..io.archive import save_archive, filename_epoch

    if args.single_pulse and not args.turns:
        args.turns = 1
    if args.predictors_file:
        # -w: one predictor spec per line (reference multi-predictor file)
        with open(args.predictors_file) as f:
            args.pulsar.extend(
                ln.strip() for ln in f if ln.strip() and not ln.startswith("#"))
    excision_kw = {}
    if args.excision:
        # -2 n<samples> c<sigma>, ':' or ',' separated (reference -2 code)
        for tok in args.excision.replace(",", ":").split(":"):
            tok = tok.strip()
            if not tok:
                continue
            if tok[0] in "nN":
                excision_kw["ndat_per_weight"] = int(tok[1:])
            elif tok[0] in "cC":
                excision_kw["cutoff_sigma"] = float(tok[1:])
            elif tok in ("fixed", "static"):
                # plain BitTable levels, no JA98 dynamic correction or
                # excision (the reference selects this per format; here a
                # -2 token overrides the instrument default)
                excision_kw["dynamic_twobit"] = False
            else:
                print(f"dspsr-jax: unknown -2 token {tok!r}", file=sys.stderr)
                return 1

    def note(msg):
        if not args.quiet:
            print(f"dspsr-jax: {msg}", file=sys.stderr)

    # reference options accepted for argv compatibility: say what happens
    # instead of silently no-opping (PARITY.md option audit)
    if args.order is not None:
        note("-order ignored: data order is always FPT on this runtime")
    if args.asynch_fold:
        note("-asynch-fold is inherent: jax dispatch already overlaps "
             "host and device work")
    if args.skzn is not None:
        note("-skzn ignored: SK runs inside the device program, there is "
             "no CPU thread pool")
    if args.skz_no_ft:
        note("-skz_no_ft is a no-op: no despeckeler is implemented")
    if args.sk_fold:
        note("-sk_fold not supported: the SKFilterbank output fold is "
             "not implemented")
    if args.ndim is not None:
        note("-n ignored: archive dimensions follow -d")

    # -x nfft | min | minXu, with an optional (ignored) :D nsmear suffix
    freq_res = None
    times_min_nfft = 0
    if args.freq_res is not None:
        spec = str(args.freq_res)
        if ":" in spec:
            spec, nsmear = spec.split(":", 1)
            note(f"-x :{nsmear} (nsmear override) ignored: the smear "
                 "comes from the dispersion kernel")
        if spec == "min":
            times_min_nfft = 1
        elif spec.startswith("minX"):
            times_min_nfft = int(spec[4:])
        else:
            freq_res = int(spec)

    # -U MB | min | minXu (u times the minimum block = u FFT windows)
    # and -minram MB (block-size floor)
    ram_kw = {}
    block_parts = args.block_parts
    if args.ram_mb is not None:
        spec = str(args.ram_mb)
        if spec == "min":
            block_parts = 1
        elif spec.startswith("minX"):
            block_parts = int(spec[4:])
        else:
            ram_kw["min_block_samples"] = int(float(spec) * 1e6 / 4)
    if args.minram:
        ram_kw["min_block_samples"] = max(
            ram_kw.get("min_block_samples", 0),
            int(args.minram * 1e6 / 4))

    cfg = FoldConfig(
        dispersion_measure=args.dm,
        nchan=args.nchan,
        frequency_resolution=freq_res,
        times_minimum_nfft=times_min_nfft,
        coherent=not args.incoherent,
        nbin=args.nbin,
        folding_period=args.period,
        polyco_path=args.polyco,
        ephemeris_path=args.ephemeris,
        calibration_path=args.poln_cal,
        use_fft_bench=args.fft_bench,
        reference_phase=args.phase,
        reference_epoch=args.cepoch,
        npol_out=args.npol,
        detection=args.detect,
        minimum_integration_length=args.minimum_integration,
        subint_seconds=args.subint,
        subint_turns=args.turns,
        integration_reference_epoch=args.Lepoch,
        fractional_pulses=args.fractional_pulses,
        report=args.report,
        block_parts=block_parts,
        rfi_filter=args.zap_rfi,
        rfi_median_width=args.rfi_median,
        rfi_threshold=args.rfi_threshold,
        sk_enable=args.skz,
        sk_m=args.skzm,
        sk_std_devs=args.skzs,
        sk_no_tscr=args.skz_no_tscr,
        sk_no_fscr=args.skz_no_fscr,
        sk_chan_start=args.skz_start,
        sk_chan_end=args.skz_end,
        sk_also_unzapped=args.noskz_too,
        seek_seconds=args.seek,
        interchannel_align=args.interchannel_align,
        fourth_moment=args.fourth_moment,
        cyclic_nchan=args.cyclic,
        cyclic_mover=args.cyclic_mover,
        dump_path=args.dump,
        additional_pulsars=tuple(
            float(s) if s.replace(".", "", 1).isdigit() else s
            for s in args.pulsar),
        fft_window=(None if args.fft_window in (None, "none")
                    else args.fft_window),
        passband=args.passband,
        pdmp_stats=args.pdmp,
        # -no_dyn: no dynamic archive extensions (digitizer histograms)
        digitizer_stats=not args.no_dyn,
        **excision_kw,
        **ram_kw,
    )

    if args.header:
        from ..io.sources import RawFileSource, observation_from_keyvals

        src = RawFileSource(args.files[0], observation_from_keyvals(args.header))
    else:
        src = (open_source(args.files[0]) if len(args.files) == 1
               else MultiFile(args.files))
    if (args.name or args.set or args.bandwidth is not None
            or args.frequency is not None or args.telescope
            or args.mjd or args.offset_clock):
        # ObservationChange (--set key=value + -N/-B/-f/-k/--mjd/-C):
        # override metadata on the data-side Observation before construction
        o = src.obs
        if args.name:
            o = o.replace(source=args.name)
        if args.bandwidth is not None:
            o = o.replace(bandwidth=args.bandwidth)
        if args.frequency is not None:
            o = o.replace(centre_frequency=args.frequency)
        if args.telescope:
            o = o.replace(telescope=args.telescope)
        if args.mjd:
            from ..timing.mjd import MJD
            o = o.replace(start_time=MJD.from_mjd(float(args.mjd)))
        if args.offset_clock:
            o = o.replace(start_time=o.start_time + args.offset_clock)
        for kv in args.set:
            k, _, v = kv.partition("=")
            o = o.replace(**{k: coerce_set_value(o, k, v)})
        src.obs = o
    if not args.quiet:
        o = src.obs
        print(f"dspsr-jax: {o.source} {o.centre_frequency} MHz BW {o.bandwidth} "
              f"nchan {o.nchan} npol {o.npol} nbit {o.nbit} "
              f"rate {o.rate/1e6:.3f} Msamp/s", file=sys.stderr)

    if args.plfb_bin:
        return _run_plfb(args, src)

    if args.threads * args.chan_shards > 1:
        from ..parallel.sharded import make_mesh
        from ..parallel.pipeline import ShardedFoldPipeline

        mesh = make_mesh(args.threads * args.chan_shards, args.chan_shards)
        pipe = ShardedFoldPipeline(src, cfg, mesh)
        if not args.quiet:
            print(f"dspsr-jax: mesh ({args.threads} time x "
                  f"{args.chan_shards} chan)", file=sys.stderr)
            print("dspsr-jax: compiling device programs for this geometry "
                  "(a first run can take minutes; cached for re-runs)",
                  file=sys.stderr)
        res = pipe.run()
        out = args.output or filename_epoch(res)
        save_archive(out, res)
        _run_jobs(args, out)
        if not args.quiet:
            print(f"dspsr-jax: wrote {out}", file=sys.stderr)
        return 0
    pipe = FoldPipeline(src, cfg)
    if not args.quiet:
        print(f"dspsr-jax: folding {pipe.nbin} bins, period {pipe.folding_period*1e3:.6f} ms, "
              f"DM {pipe.dm}, nchan_out {pipe.obs_out.nchan}", file=sys.stderr)

    if not args.quiet:
        # cold-compile can take minutes on a new geometry; say so instead
        # of sitting silent (the persistent executable cache makes
        # re-runs fast, utils/platform.enable_compilation_cache)
        print("dspsr-jax: compiling device programs for this geometry "
              "(a first run can take minutes; cached for re-runs)",
              file=sys.stderr)
    ipass = 0
    while True:
        res = pipe.run(total_seconds=args.total)
        ext = args.extension or ("ar" if args.archive == "psrfits" else "npz")
        out = args.output or filename_epoch(res, ext=ext)
        if args.repeat is not None and ipass > 0:
            root, dot, ext = out.rpartition(".")
            out = f"{root}_r{ipass}{dot}{ext}" if dot else f"{out}_r{ipass}"
        if args.nsub and res.profiles.shape[0] > args.nsub:
            # --nsub: one archive per N subints, sequence-numbered
            # (reference subints_per_archive; FilenameSequential)
            root, dot, ext2 = out.rpartition(".")
            nsub_tot = res.profiles.shape[0]
            outs = []
            for i, lo in enumerate(range(0, nsub_tot, args.nsub)):
                part = _slice_result(res, lo, min(lo + args.nsub, nsub_tot))
                po = (f"{root}_{i:04d}{dot}{ext2}" if dot
                      else f"{out}_{i:04d}")
                save_archive(po, part)
                _run_jobs(args, po)
                outs.append(po)
            out = outs[-1]
        else:
            save_archive(out, res)
            _run_jobs(args, out)
        for i, extra in enumerate(res.extra_sources or []):
            root, dot, e2 = out.rpartition(".")
            if extra.label:
                # -noskz_too: the un-zapped fold takes the reference's
                # ".nosk" extension convention
                p2 = (f"{root}.{extra.label}{dot}{e2}" if dot
                      else f"{out}.{extra.label}")
            else:
                p2 = (f"{root}_src{i + 1}{dot}{e2}" if dot
                      else f"{out}_src{i + 1}")
            save_archive(p2, extra)
            _run_jobs(args, p2)
        if not args.quiet:
            nsub = res.profiles.shape[0]
            print(f"dspsr-jax: wrote {out} ({nsub} subint(s), "
                  f"{float(res.integration_length.sum()):.3f} s integrated)",
                  file=sys.stderr)
        ipass += 1
        if args.repeat is None or (args.repeat > 0 and ipass > args.repeat):
            break
        # soak pass: fresh accumulators over the same (reopened) input
        pipe = FoldPipeline(src, cfg)
    return 0


def _run_plfb(args, src) -> int:
    """Phase-locked filterbank mode (reference -G, LoadToFold1.C:386-430)."""
    import numpy as np
    from ..ops.phase_locked import phase_locked_fold
    from ..timing.polyco import Polyco, FixedPeriodPredictor, SpinPredictor
    from ..timing.par import Ephemeris

    if args.period:
        pred = FixedPeriodPredictor(args.period, src.obs.start_time)
    elif args.polyco:
        pred = Polyco.load(args.polyco)
    elif args.ephemeris:
        pred = SpinPredictor.from_ephemeris(
            Ephemeris.load(args.ephemeris), telescope=src.obs.telescope)
    else:
        print("dspsr-jax: PLFB mode needs -c, -P or -E", file=sys.stderr)
        return 1

    obs = src.obs
    max_blocks = None
    block = 1 << 20
    if args.total:
        nsamp = int(args.total * obs.rate)
        max_blocks = max(1, nsamp // block)
    res = phase_locked_fold(src, pred, nbin=args.plfb_bin,
                            nchan=args.plfb_chan, npol_out=args.npol,
                            block_samples=block, max_blocks=max_blocks)
    out = args.output or f"{obs.source or 'plfb'}_{obs.start_time.in_days():.4f}_plfb.npz"
    np.savez(out, spectra=res.spectra, hits=res.hits,
             nbin=res.plan.nbin, nchan=res.plan.nchan,
             npol=res.plan.npol_out,
             centre_frequency=obs.centre_frequency, bandwidth=obs.bandwidth,
             source=obs.source or "")
    if not args.quiet:
        print(f"dspsr-jax: wrote {out} (PLFB {res.plan.nbin} bins x "
              f"{res.spectra.shape[0]} chan, {int(res.hits.sum())} spectra)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
