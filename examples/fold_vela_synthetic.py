"""End-to-end example: synthesize a dispersed pulsar, fold it, plot profile.

Run: python examples/fold_vela_synthetic.py  (CPU-friendly; ~30 s)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main():
    import jax

    from dspsr_jax.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    from test_pipeline import synth_pulsar_dada, PERIOD, DM, PULSE_PHASE
    from dspsr_jax.models.load_to_fold import FoldConfig, load_to_fold
    from dspsr_jax.io.archive import save_archive

    path = "/tmp/example_pulsar.dada"
    print("synthesizing a DM=150 pulsar into", path)
    synth_pulsar_dada(path, nsec=0.5)

    cfg = FoldConfig(
        folding_period=PERIOD,
        dispersion_measure=DM,
        nchan=8,
        npol_out=1,
        subint_seconds=0.1,
        report=True,
    )
    res = load_to_fold(path, cfg)
    save_archive("/tmp/example_pulsar.sf", res)
    print("wrote /tmp/example_pulsar.sf (PSRFITS)")

    prof = res.dedispersed().sum(axis=(0, 1))[0]  # sum subints + channels
    nbin = len(prof)
    peak = prof.argmax() / nbin
    print(f"profile peak at phase {peak:.3f} (injected {PULSE_PHASE})")
    # poor-man's terminal plot
    lo, hi = prof.min(), prof.max()
    for i in range(0, nbin, max(nbin // 32, 1)):
        bar = "#" * int(50 * (prof[i] - lo) / (hi - lo + 1e-30))
        print(f"{i / nbin:5.2f} {bar}")


if __name__ == "__main__":
    main()
