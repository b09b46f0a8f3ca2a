"""Fold and search pipeline throughput on one GPU, and the flagship's
per-layer device profile.

    python bench.py            # JSON lines: the headline, then the matrix
    python bench.py --layers   # device time of each layer of the flagship

The headline reproduces the reference's benchmark configuration
(``Benchmark/fold.csh``: 8-bit dual-pol real-sampled 400 MHz CASPSR
baseband of J0437-4715, coherent dedispersion into 64 channels + fold into
1024 bins) with 2^25-sample blocks.  The raw bytes are generated on the
device (the reference's ``DummyFile`` role), so the figure is the device
pipeline's rate; ``h2d_fed_msps`` feeds host bytes instead.  ``value`` is
the median over reps of raw input Msamples/s per chip and ``vs_baseline``
the real-time ratio against the 800 Msamples/s CASPSR rate
(``fold.csh:33-36``).  A line is printed after the headline and after
every matrix entry, each complete on its own.  Every line names the
device (platform, kind, count) and the card's power limit.

``--layers`` traces three flagship steps with ``jax.profiler`` and sums
the device time of the kernels under each ``jax.named_scope`` of
``FoldPipeline._step_core`` (unpack, forward_fft, response, inverse_fft,
detect, fold).  XLA fuses across scopes; a fused kernel counts toward the
scope of its root instruction.  The trace and the per-kernel list go to
``bench_out/`` (``--layers DIR`` puts them in DIR instead).

Knobs: DSPSR_BENCH_REPS (5), DSPSR_BENCH_NBLOCKS (6),
DSPSR_BENCH_MATRIX (1; 0 = headline only), DSPSR_BENCH_BUDGET_S
(1200).
"""

import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

RATE = 800e6
#: J0437-4715's topocentric period (s), folded at a fixed period
PERIOD = 0.005757451
LAYERS = ("unpack", "forward_fft", "response", "inverse_fft", "detect",
          "fold")
#: published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def card_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench: no GPU ({d.platform}); not measuring")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_power()}


def _make_obs(nchan=1, npol=2, ndim=1, nbit=8, rate=RATE, bw=-400.0):
    from dspsr_jax.observation import Observation, Signal
    from dspsr_jax.timing.mjd import MJD

    return Observation(
        nchan=nchan, npol=npol, ndim=ndim, nbit=nbit,
        centre_frequency=1382.0, bandwidth=bw, rate=rate,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=(Signal.NYQUIST if ndim == 1 else Signal.ANALYTIC),
        source="J0437-4715", telescope="PKS", instrument="DUMMY",
    ).replace(ndat=1 << 40)


def flagship_config(**kw):
    from dspsr_jax.models.load_to_fold import FoldConfig

    base = dict(folding_period=PERIOD, dispersion_measure=2.64, nchan=64,
                nbin=1024, npol_out=1, min_block_samples=1 << 25)
    base.update(kw)
    return FoldConfig(**base)


def fold_stepper(obs, cfg):
    """(pipeline, step(profiles, hits, block_index), initial accumulators,
    the jitted step and its arguments for a block) with device-generated
    raw bytes."""
    import jax
    import jax.numpy as jnp
    from dspsr_jax.io.sources import DummySource, device_noise_bytes
    from dspsr_jax.models.load_to_fold import FoldPipeline
    from dspsr_jax.ops.fold import compute_anchors

    pipe = FoldPipeline(DummySource(obs), cfg)
    seg = pipe.fold_plan.seg_len
    nuse = -(-pipe.out_per_block // seg) * seg
    nbytes = int(round(pipe.block_in_samples * obs.nbytes_per_sample))

    @jax.jit
    def devgen_step(profiles, hits, start_byte, phi0, dphi):
        raw = device_noise_bytes(start_byte, nbytes)
        return pipe._step(profiles, hits, raw, phi0, dphi)[:2]

    def block_args(b):
        t0 = pipe.output_start_time(b * pipe.stride_in_samples)
        phi0, dphi = compute_anchors(pipe.predictor, t0,
                                     1.0 / pipe.obs_out.rate, nuse, seg)
        return jnp.uint32(b * nbytes), jnp.asarray(phi0), jnp.asarray(dphi)

    def step(profiles, hits, b):
        return devgen_step(profiles, hits, *block_args(b))

    acc = (jnp.zeros((pipe.obs_out.nchan, pipe.obs_out.npol, pipe.nbin),
                     jnp.float32),
           jnp.zeros((pipe.obs_out.nchan, pipe.nbin), jnp.float32))
    return pipe, step, acc, devgen_step, block_args


def bench_fold(obs, cfg, reps, nblocks, h2d=False):
    """Raw-input Msamples/s of the fold pipeline."""
    import jax
    import jax.numpy as jnp
    from dspsr_jax.ops.fold import compute_anchors

    pipe, step, (profiles, hits), _, _ = fold_stepper(obs, cfg)
    stride = pipe.stride_in_samples
    t0 = time.perf_counter()
    profiles, hits = jax.block_until_ready(step(profiles, hits, 0))
    compile_s = time.perf_counter() - t0
    per_rep = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for b in range(nblocks):
            profiles, hits = step(profiles, hits, b)
        jax.block_until_ready(hits)
        per_rep.append(round(nblocks * stride / (time.perf_counter() - t0)
                             / 1e6, 2))
    out = {
        "msps": statistics.median(per_rep),
        "per_rep_msps": per_rep,
        "compile_s": round(compile_s, 1),
        "block_samples": stride,
        "nchan_out": pipe.obs_out.nchan,
        "nbin": pipe.nbin,
    }
    if h2d:
        # host-fed: the bytes of one block cross to the device every step
        raw = pipe.source.read_samples(0, pipe.block_in_samples)
        seg = pipe.fold_plan.seg_len
        nuse = -(-pipe.out_per_block // seg) * seg
        phi0, dphi = compute_anchors(pipe.predictor, pipe.output_start_time(0),
                                     1.0 / pipe.obs_out.rate, nuse, seg)
        args = (jnp.asarray(phi0), jnp.asarray(dphi))
        res = pipe._step(profiles, hits, jnp.asarray(raw), *args)
        jax.block_until_ready(res)
        profiles, hits = res[0], res[1]
        t0 = time.perf_counter()
        for _ in range(3):
            res = pipe._step(profiles, hits, jnp.asarray(raw), *args)
            profiles, hits = res[0], res[1]
        jax.block_until_ready(hits)
        out["h2d_fed_msps"] = round(
            3 * stride / (time.perf_counter() - t0) / 1e6, 2)
    return out


def bench_fil(obs, cfg, reps, nblocks):
    """Raw-input Msamples/s of the search-mode (digifil) pipeline."""
    import jax
    import jax.numpy as jnp
    from dspsr_jax.io.sources import DummySource, device_noise_bytes
    from dspsr_jax.models.load_to_fil import FilPipeline

    pipe = FilPipeline(DummySource(obs), cfg)
    nbytes = int(round(pipe.block_in_samples * obs.nbytes_per_sample))
    st, mean, inv = pipe._rescale_state, pipe._mean, pipe._inv

    @jax.jit
    def devgen(start_byte):
        raw = device_noise_bytes(start_byte, nbytes)
        packed = pipe._step(st, mean, inv, raw, "cumulative")[3]
        return jnp.sum(packed[-8:].astype(jnp.float32))

    t0 = time.perf_counter()
    jax.block_until_ready(devgen(jnp.uint32(0)))
    compile_s = time.perf_counter() - t0
    per_rep = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = [devgen(jnp.uint32(b * nbytes)) for b in range(nblocks)]
        jax.block_until_ready(acc)
        per_rep.append(round(nblocks * pipe.stride_in_samples
                             / (time.perf_counter() - t0) / 1e6, 2))
    return {"msps": statistics.median(per_rep), "per_rep_msps": per_rep,
            "compile_s": round(compile_s, 1),
            "block_samples": pipe.stride_in_samples,
            "nchan_out": pipe.obs_out.nchan}


# ------------------------------------------------------------ layers

def _layer_of(op_name: str):
    for layer in LAYERS:
        if f"/{layer}/" in f"/{op_name}/":
            return layer
    return None


def _hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> layer, from the op_name metadata (the
    named-scope path) of the optimized module.  A fusion whose own
    metadata is the common prefix of its parts takes the layer of its
    fused computation's root; the key ``"gemm"`` holds the layer of the
    cuBLAS calls when they all share one."""
    comp_layer, insts = {}, {}
    comp, body = None, []
    head = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
    inst = re.compile(r"^\s+(ROOT\s+)?%?([\w.\-]+)\s*=")
    for line in hlo_text.splitlines():
        m = head.match(line)
        if m:
            comp, body = m.group(1), []
            continue
        if line.startswith("}") and comp is not None:
            roots = [ly for root, ly in body if root and ly]
            named = [ly for _, ly in body if ly]
            comp_layer[comp] = (roots[0] if roots else
                                max(set(named), key=named.count)
                                if named else None)
            comp = None
            continue
        m = inst.match(line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        layer = _layer_of(op.group(1)) if op else None
        calls = re.search(r"calls=%?([\w.\-]+)", line)
        gemm = "gemm" in line and "custom-call" in line
        insts[m.group(2)] = (layer, calls.group(1) if calls else None, gemm)
        body.append((bool(m.group(1)), layer))
    out = {}
    for name, (layer, calls, _) in insts.items():
        layer = layer or comp_layer.get(calls)
        if layer:
            out[name] = layer
    gemm_layers = {out.get(n) for n, (_, _, g) in insts.items() if g}
    if len(gemm_layers) == 1 and None not in gemm_layers:
        out["gemm"] = gemm_layers.pop()
    return out


def reduce_trace(trace_dir: str, hlo_text: str,
                 plane_prefix: str = "/device:GPU") -> dict:
    """Device time per layer (ns) from a profiler trace: every event on a
    GPU plane's kernel lines is attributed through its HLO op name."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    scopes = _hlo_scopes(hlo_text)
    totals = {k: 0 for k in LAYERS}
    totals["other"] = 0
    samples = []
    busy = []
    for plane in prof.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                # kernels run from a command buffer carry no hlo_op; a
                # fusion's kernel is named after the fusion instruction
                layer = (scopes.get(str(stats.get("hlo_op")))
                         or scopes.get(ev.name)
                         or _layer_of(str(stats.get("name", ""))))
                if layer is None and "gemm" in ev.name:
                    layer = scopes.get("gemm")
                totals[layer or "other"] += ev.duration_ns
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                samples.append({"layer": layer, "name": ev.name[:80],
                                "ns": ev.duration_ns,
                                "hlo_op": str(stats.get("hlo_op", ""))})
    busy.sort()
    union, end = 0, None
    for a, b in busy:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    span = (busy[-1][1] - busy[0][0]) if busy else 0
    return {"layer_ns": totals, "busy_ns": union, "span_ns": span,
            "samples": samples}


def layer_model(pipe) -> dict:
    """Least bytes moved and flops per layer for one block, from shapes."""
    fb = pipe.fb_plan
    npol, nchan = pipe.obs_in.npol, pipe.obs_out.nchan
    t_in = pipe.block_in_samples * npol
    nwin = pipe.npart * npol
    n_real = fb.nsamp_fft
    bins = nwin * fb.n_fft
    t_out = pipe.out_per_block
    lg = np.log2
    return {
        "unpack": {"bytes": t_in * (1 + 4), "flops": t_in},
        "forward_fft": {"bytes": nwin * (4 * n_real + 8 * fb.n_fft),
                        "flops": 2.5 * nwin * n_real * lg(n_real)},
        "response": {"bytes": 16 * bins, "flops": 6 * bins},
        "inverse_fft": {"bytes": 16 * bins,
                        "flops": 5 * bins * lg(fb.freq_res)},
        "detect": {"bytes": nchan * t_out * (8 * npol + 4),
                   "flops": 4 * nchan * t_out * npol},
        "fold": {"bytes": 4 * nchan * t_out,
                 "flops": 2 * nchan * t_out * pipe.nbin},
    }


def layers_main(out_dir: str) -> int:
    import jax

    info = device_info()
    pipe, step, (profiles, hits), jitted, block_args = fold_stepper(
        _make_obs(), flagship_config())
    hlo = jitted.lower(profiles, hits, *block_args(0)).compile().as_text()
    profiles, hits = jax.block_until_ready(step(profiles, hits, 0))
    trace_dir = os.path.join(out_dir, "layers_trace")
    nsteps = 3
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for b in range(nsteps):
            profiles, hits = step(profiles, hits, b)
        jax.block_until_ready(hits)
    wall = time.perf_counter() - t0
    red = reduce_trace(trace_dir, hlo)
    with open(os.path.join(out_dir, "layers_kernels.json"), "w") as f:
        json.dump(red["samples"], f, indent=1)
    model = layer_model(pipe)
    peaks = PEAKS.get(info["kind"])
    rows = {}
    for layer in LAYERS:
        ns = red["layer_ns"][layer] / nsteps
        row = {"device_ms": ns / 1e6}
        m = model[layer]
        if peaks and ns > 0:
            t_bytes = m["bytes"] / peaks["hbm_bytes"]
            t_flops = m["flops"] / peaks["fp32_flops"]
            row["roofline_share"] = max(t_bytes, t_flops) / (ns * 1e-9)
            row["bound"] = "bytes" if t_bytes >= t_flops else "fp32 flops"
        rows[layer] = row
    rows["other"] = {"device_ms": red["layer_ns"]["other"] / nsteps / 1e6}
    line = {"metric": "flagship_layer_device_time", "device": info,
            "block_samples": pipe.stride_in_samples, "steps": nsteps,
            "busy_ms_per_step": red["busy_ns"] / nsteps / 1e6,
            "span_ms": red["span_ns"] / 1e6, "wall_ms_traced": wall * 1e3,
            "layers": rows}
    print(json.dumps(line))
    if peaks is None:
        print(f"bench: no peak table entry for {info['kind']!r}",
              file=sys.stderr)
        return 1
    return 0


# -------------------------------------------------------------- main

def main() -> int:
    t_start = time.monotonic()
    from dspsr_jax.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    import jax

    jax.config.update("jax_platforms", "cuda")
    args = sys.argv[1:]
    if "--layers" in args:
        i = args.index("--layers")
        out_dir = args[i + 1] if i + 1 < len(args) else "bench_out"
        return layers_main(out_dir)
    info = device_info()

    from dspsr_jax.models.load_to_fil import FilConfig

    reps = int(os.environ.get("DSPSR_BENCH_REPS", 5))
    nblocks = int(os.environ.get("DSPSR_BENCH_NBLOCKS", 6))
    do_matrix = os.environ.get("DSPSR_BENCH_MATRIX", "1") != "0"
    budget_s = float(os.environ.get("DSPSR_BENCH_BUDGET_S", 1200))

    flagship = flagship_config()
    head = bench_fold(_make_obs(), flagship, reps, nblocks, h2d=True)
    matrix = {"flagship": head}
    out = {
        "metric": "fold_pipeline_throughput",
        "value": head["msps"],
        "unit": "Msamples/s/chip",
        "vs_baseline": round(head["msps"] * 1e6 / RATE, 4),
        "reps": reps,
        "device": info,
        "matrix": matrix,
    }

    def emit():
        out["elapsed_s"] = round(time.monotonic() - t_start, 1)
        print(json.dumps(out))
        sys.stdout.flush()

    emit()
    if not do_matrix:
        return 0
    mreps, mblocks = 3, 2
    entries = [
        ("analytic_8bit", lambda: bench_fold(
            _make_obs(ndim=2, rate=400e6),
            flagship_config(min_block_samples=1 << 24), mreps, mblocks)),
        ("sk", lambda: bench_fold(
            _make_obs(), flagship_config(sk_enable=True, sk_m=1024),
            mreps, mblocks)),
        ("rfi", lambda: bench_fold(
            _make_obs(), flagship_config(rfi_filter=True), mreps, mblocks)),
        ("cyclic", lambda: bench_fold(
            _make_obs(), flagship_config(cyclic_nchan=64,
                                         min_block_samples=1 << 24),
            mreps, mblocks)),
        # 32 coarse channels convolved at their own chirps, no further
        # channelization (dspsr without -F on a channelized band)
        ("conv32", lambda: bench_fold(
            _make_obs(nchan=32, ndim=2, rate=12.5e6),
            flagship_config(nchan=32, dispersion_measure=71.0,
                            frequency_resolution=1 << 19, block_parts=4,
                            min_block_samples=0), mreps, mblocks)),
        # GUPPI-like: 32 coarse channels of 2-bit complex, JA98 levels +
        # excision weights, 64 subbands each
        ("guppi_2bit", lambda: bench_fold(
            _make_obs(nchan=32, ndim=2, nbit=2, rate=12.5e6),
            flagship_config(nchan=2048, dispersion_measure=71.0,
                            frequency_resolution=2048, ndat_per_weight=256,
                            block_parts=16, min_block_samples=0),
            mreps, mblocks)),
        ("search", lambda: bench_fil(
            _make_obs(), FilConfig(nchan=64, dispersion_measure=2.64,
                                   nbits=8, min_block_samples=1 << 25),
            mreps, mblocks)),
    ]
    for tag, thunk in entries:
        if time.monotonic() - t_start > budget_s:
            matrix[tag] = {"skipped": "budget"}
            continue
        try:
            matrix[tag] = thunk()
        except Exception as e:  # record the failure, measure the rest
            matrix[tag] = {"error": f"{type(e).__name__}: {e}"}
        emit()
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
