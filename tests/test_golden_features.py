"""Golden-model tests of the chain's excision, cyclic and tap features:
spectral kurtosis, the RFI filter (filterbank and nsub == 1 convolution,
scalar and Jones), cyclic folding, and the dump / passband / pdmp taps —
each against the float64 model in dspsr_jax.golden (see test_golden.py)."""

import numpy as np
import pytest

from dspsr_jax.io.sources import DADAFile
from test_golden import assert_matches, make_obs, run_case

CONV = dict(nchan=1, frequency_resolution=256, dispersion_measure=0.005)

FEATURES = {
    "sk_fb": (dict(nchan=2), dict(nchan=8, sk_enable=True, sk_m=32),
              "burst"),
    "sk_conv": (dict(), dict(CONV, sk_enable=True, sk_m=64), "burst"),
    "sk_chan_range": (dict(nchan=2),
                      dict(nchan=8, sk_enable=True, sk_m=32,
                           sk_chan_start=2, sk_chan_end=6, sk_no_tscr=True),
                      "burst"),
    "cyclic": (dict(), dict(nchan=1, cyclic_nchan=8,
                            frequency_resolution=128, dispersion_measure=0.01),
               "uniform"),
    "rfi_fb": (dict(), dict(rfi_filter=True, rfi_median_width=9), "tone"),
    "rfi_conv": (dict(), dict(CONV, rfi_filter=True, rfi_median_width=9),
                 "tone"),
    "rfi_conv_jones": (dict(), dict(CONV, rfi_filter=True,
                                    rfi_median_width=9, npol_out=4,
                                    calibration_path="jones"), "tone"),
    "rfi_real_conv": (dict(ndim=1), dict(CONV, rfi_filter=True,
                                         rfi_median_width=9), "tone"),
}


@pytest.mark.parametrize("case", sorted(FEATURES))
def test_features_match_golden(tmp_path, case):
    obskw, cfgkw, kind = FEATURES[case]
    res, gold, pipe = run_case(tmp_path, make_obs(**obskw), cfgkw, kind)
    assert_matches(res, gold, tol=5e-5)
    if case.startswith("sk"):
        # the loud stretch was excised
        assert res.hits.sum() < res.hits.max() * res.hits.size


@pytest.mark.parametrize("geometry", ["fb", "conv"])
def test_rfi_filter_zaps_tone(tmp_path, geometry):
    """-R removes most of a strong tone's power relative to the unfiltered
    fold (the golden cases above check the exact mask)."""
    cfg = dict(CONV) if geometry == "conv" else {}
    on, _, _ = run_case(tmp_path, make_obs(), dict(cfg, rfi_filter=True,
                                                   rfi_median_width=9),
                        "tone")
    off, _, _ = run_case(tmp_path, make_obs(), cfg, "tone")
    assert on.profiles.sum() < 0.9 * off.profiles.sum()


@pytest.mark.parametrize("geometry", ["fb", "conv"])
def test_passband_tap_matches_golden(tmp_path, geometry):
    cfg = dict(CONV) if geometry == "conv" else {}
    res, gold, pipe = run_case(tmp_path, make_obs(), dict(cfg, passband=True))
    assert res.passband.shape == gold["passband"].shape
    scale = np.abs(gold["passband"]).max()
    assert np.abs(res.passband - gold["passband"]).max() / scale < 2e-5


def test_pdmp_moments_match_golden(tmp_path):
    res, gold, pipe = run_case(tmp_path, make_obs(), dict(pdmp_stats=True))
    want = gold["moments"]
    for k in range(4):
        scale = np.abs(want[..., k]).max()
        assert np.abs(res.pdmp_stats[..., k] - want[..., k]).max() \
            / scale < 1e-4


@pytest.mark.parametrize("geometry", ["fb", "conv"])
def test_dump_tap_matches_golden(tmp_path, geometry):
    """--dump writes the detected stream (TFP float32 DADA) that the
    golden model detects."""
    dump = str(tmp_path / "dump.dada")
    cfg = dict(CONV) if geometry == "conv" else {}
    res, gold, pipe = run_case(tmp_path, make_obs(),
                               dict(cfg, dump_path=dump, npol_out=2))
    src = DADAFile(dump)
    n = src.total_samples
    tfp = np.frombuffer(src.read_samples(0, n).tobytes(), "<f4")
    got = tfp.reshape(n, src.obs.nchan, src.obs.npol).transpose(1, 2, 0)
    want = gold["detected"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-5
