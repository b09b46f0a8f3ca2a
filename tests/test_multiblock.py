"""blocks_per_step batching: scanned multi-block step == single-block steps."""

import numpy as np
import pytest

from dspsr_jax.models.load_to_fold import FoldConfig, load_to_fold
from test_pipeline import synth_pulsar_dada, PERIOD, DM, PULSE_PHASE


def test_multiblock_equals_single(tmp_path):
    p = str(tmp_path / "mb.dada")
    synth_pulsar_dada(p, nsec=0.3)
    base = dict(folding_period=PERIOD, dispersion_measure=DM,
                nchan=4, block_parts=2, min_block_samples=1 << 17)
    r1 = load_to_fold(p, FoldConfig(**base, blocks_per_step=1))
    r4 = load_to_fold(p, FoldConfig(**base, blocks_per_step=4))
    np.testing.assert_array_equal(r1.hits, r4.hits)
    np.testing.assert_allclose(r1.profiles, r4.profiles, rtol=1e-5, atol=1e-3)


def test_multiblock_with_subints(tmp_path):
    p = str(tmp_path / "mbs.dada")
    synth_pulsar_dada(p, nsec=0.4)
    base = dict(folding_period=PERIOD, dispersion_measure=DM,
                subint_seconds=0.1, block_parts=2, min_block_samples=1 << 16)
    r1 = load_to_fold(p, FoldConfig(**base, blocks_per_step=1))
    r8 = load_to_fold(p, FoldConfig(**base, blocks_per_step=8))
    assert r1.profiles.shape == r8.profiles.shape
    np.testing.assert_array_equal(r1.hits, r8.hits)
    np.testing.assert_allclose(r1.profiles, r8.profiles, rtol=1e-5, atol=1e-3)
