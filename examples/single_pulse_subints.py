"""Single-pulse sub-integrations with sample-exact boundaries.

Demonstrates the round-5 TimeDivide/SubFold semantics (reference
``Signal/Pulsar/TimeDivide.C`` + ``SubFold.C``): with ``-s`` every pulse
becomes its own sub-integration whose boundaries sit at the predictor's
phase-0 crossings, EXACT to one output sample — even though each FFT
window spans several pulses, the fold splits blocks internally with
per-sample bounds.  Also shows -y (fractional pulses) keeping the
partial first pulse.

Run: python examples/single_pulse_subints.py  (CPU-friendly; ~1 min)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main():
    from dspsr_jax.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    from test_pipeline import synth_pulsar_dada, PERIOD, DM
    from dspsr_jax.io.sources import open_source
    from dspsr_jax.models.load_to_fold import FoldConfig, FoldPipeline

    path = "/tmp/example_single_pulse.dada"
    print(f"synthesizing a {PERIOD*1e3:.1f} ms pulsar (DM={DM}) ->", path)
    synth_pulsar_dada(path, nsec=0.25)

    cfg = FoldConfig(
        folding_period=PERIOD,
        dispersion_measure=DM,
        nchan=4,
        nbin=64,
        subint_turns=1,            # -s: one subint per pulse
        frequency_resolution=32768,  # window = 32.8 ms >> one 5 ms pulse
        min_block_samples=0,
    )
    pipe = FoldPipeline(open_source(path), cfg)
    res = pipe.run()
    rate_out = pipe.obs_out.rate

    print(f"\n{len(res.epochs)} single-pulse subints "
          f"(FFT window {32768 / rate_out * 1e3:.1f} ms, "
          f"period {PERIOD*1e3:.1f} ms -> ~6.5 pulses per window)")
    print("subint  epoch offset [ms]  length [ms]  pulse phase at epoch")
    t0 = pipe.output_start_time(0)
    for k in range(min(8, len(res.epochs))):
        ph = pipe.predictor.fracturns(res.epochs[k])
        ph = min(ph, 1 - ph)
        print(f"  {k:3d}   {float(res.epochs[k] - t0)*1e3:12.4f}  "
              f"{res.integration_length[k]*1e3:10.4f}  {ph:+.2e}")

    lens = res.integration_length[1:-1]
    assert np.all(np.abs(lens - PERIOD) <= 1.5 / rate_out), \
        "interior subints must hold exactly one period"
    print("\ninterior subints hold exactly one pulse period "
          f"(max deviation {np.abs(lens - PERIOD).max()*1e6:.2f} us "
          f"= <= one output sample of {1e6/rate_out:.1f} us)")

    # -y keeps the partial first pulse as its own subint
    import dataclasses
    res_y = FoldPipeline(open_source(path), dataclasses.replace(
        cfg, fractional_pulses=True)).run()
    print(f"with -y (fractional pulses): {len(res_y.epochs)} subints; "
          f"first is the partial head "
          f"({res_y.integration_length[0]*1e3:.3f} ms < one period)")


if __name__ == "__main__":
    main()
