"""Tests for bit tables and unpackers (incl. JA98 2-bit dynamic levels)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from dspsr_jax.unpack.bittable import BitTable, CodeType, optimal_spacing
from dspsr_jax.unpack.twobit import TwoBitCorrection, optimal_flow, _erfinv
from dspsr_jax.unpack.unpackers import (
    bytes_to_codes,
    unpack_fixed,
    unpack_twobit_dynamic,
    unpack_float32,
    digitizer_histogram,
    UnpackPlan,
)
from dspsr_jax.observation import Observation, Signal


class TestBitTable:
    def test_optimal_spacing_2bit(self):
        # Max(1960)/JA98 value for a uniform 4-level quantizer: ~0.9957
        assert abs(optimal_spacing(2) - 0.9957) < 0.002

    def test_optimal_spacing_8bit_small(self):
        assert 0.02 < optimal_spacing(8) < 0.05

    def test_unit_variance(self):
        """Quantizing N(0,1) with the table's implied thresholds yields
        unit output variance (BitTable.C:214 normalization)."""
        rng = np.random.default_rng(3)
        x = rng.standard_normal(200_000)
        for nbit in (2, 4, 8):
            t = BitTable(nbit)
            d = optimal_spacing(nbit)
            n = 1 << nbit
            codes = np.clip(np.floor(x / d + n / 2).astype(int), 0, n - 1)
            y = t.values[codes]
            assert abs(np.var(y) - 1.0) < 0.02, nbit

    def test_twos_complement_reorder(self):
        t_off = BitTable(2, CodeType.OFFSET_BINARY)
        t_two = BitTable(2, CodeType.TWOS_COMPLEMENT)
        # offset binary: codes ascend 0..3 = most negative..most positive
        assert np.all(np.diff(t_off.values) > 0)
        # twos complement: 0,1 positive-side; 2,3 = negative-side
        np.testing.assert_allclose(t_two.values, np.roll(t_off.values, 2))

    def test_1bit(self):
        t = BitTable(1)
        np.testing.assert_allclose(sorted(t.values), [-1.0, 1.0])


class TestBytesToCodes:
    def test_8bit(self):
        raw = jnp.asarray(np.array([0, 127, 255], np.uint8))
        np.testing.assert_array_equal(bytes_to_codes(raw, 8), [0, 127, 255])

    def test_2bit_msb_first(self):
        # byte 0b11100100 -> fields MSB-first: 3,2,1,0
        raw = jnp.asarray(np.array([0b11100100], np.uint8))
        np.testing.assert_array_equal(bytes_to_codes(raw, 2, True), [3, 2, 1, 0])
        np.testing.assert_array_equal(bytes_to_codes(raw, 2, False), [0, 1, 2, 3])

    def test_4bit(self):
        raw = jnp.asarray(np.array([0xAB], np.uint8))
        np.testing.assert_array_equal(bytes_to_codes(raw, 4, True), [0xA, 0xB])

    def test_1bit(self):
        raw = jnp.asarray(np.array([0b10000001], np.uint8))
        got = np.asarray(bytes_to_codes(raw, 1, True))
        np.testing.assert_array_equal(got, [1, 0, 0, 0, 0, 0, 0, 1])


class TestUnpackFixed:
    def test_8bit_roundtrip_ordering(self, rng):
        """TFP bytes -> FPT floats preserves sample identity.

        Uniform level map is affine in the code, so ordering can be checked
        by inverting the affine map.
        """
        from dspsr_jax.unpack.bittable import BitTable

        nchan, npol, ndim, ndat = 2, 2, 2, 16
        vals = rng.integers(0, 256, ndat * nchan * npol * ndim).astype(np.uint8)
        xr, xi = unpack_fixed(jnp.asarray(vals), 8, nchan, npol, ndim)
        assert xr.shape == (nchan, npol, ndat)
        t = BitTable(8).values
        v = vals.reshape(ndat, nchan, npol, ndim)
        np.testing.assert_allclose(np.asarray(xr),
                                   t[v[..., 0]].transpose(1, 2, 0), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(xi),
                                   t[v[..., 1]].transpose(1, 2, 0), rtol=1e-5)

    def test_matches_bittable(self, rng):
        """Arithmetic unpack == BitTable lookup for all codes, both types."""
        from dspsr_jax.unpack.bittable import BitTable, CodeType
        from dspsr_jax.unpack.unpackers import _uniform_levels

        for nbit in (1, 2, 4, 8):
            codes = np.arange(1 << nbit, dtype=np.int32)
            for twos, ct in [(False, CodeType.OFFSET_BINARY),
                             (True, CodeType.TWOS_COMPLEMENT)]:
                got = np.asarray(_uniform_levels(jnp.asarray(codes), nbit, twos))
                expect = BitTable(nbit, ct).values
                np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)

    def test_gaussian_statistics(self, rng):
        """8-bit quantized Gaussian unpacks to ~N(0, sigma^2/scale)."""
        obs = Observation(nchan=1, npol=1, ndim=1, nbit=8, state=Signal.NYQUIST)
        plan = UnpackPlan(obs)
        d = optimal_spacing(8)
        x = rng.standard_normal(100_000)
        codes = np.clip(np.floor(x / d + 128), 0, 255).astype(np.uint8)
        y, w = plan.unpack(jnp.asarray(codes))
        assert w is None
        y = np.asarray(y).ravel()
        assert abs(np.var(y) - 1.0) < 0.02
        assert abs(np.mean(y)) < 0.02
        # high fidelity at 8 bits
        assert np.corrcoef(x, y)[0, 1] > 0.999


class TestFloat32:
    def test_bitcast(self):
        vals = np.array([1.5, -2.25, 0.0, 3e8], np.float32)
        raw = jnp.asarray(np.frombuffer(vals.tobytes(), np.uint8))
        y = unpack_float32(raw, 1, 1, 1)
        np.testing.assert_array_equal(np.asarray(y).ravel(), vals)


class TestTwoBitDynamic:
    def test_erfinv(self):
        for y in [-0.9, -0.3, 0.0001, 0.5, 0.99]:
            assert abs(math.erf(_erfinv(y)) - y) < 1e-12

    def test_optimal_flow(self):
        # JA98: at the optimal threshold ~2/3 of samples are low
        assert abs(optimal_flow() - 0.6664) < 0.001

    def test_level_tables_monotone(self):
        tb = TwoBitCorrection(ndat_per_weight=512)
        lo, hi = tb.level_tables
        # more low samples => quieter input => levels grow to compensate
        n = tb.ndat_per_weight
        f_opt = optimal_flow()
        i_opt = int(n * f_opt)
        assert hi[i_opt] > lo[i_opt] > 0
        assert lo[i_opt + 100] > lo[i_opt - 100]

    def test_unit_variance_at_optimum(self):
        tb = TwoBitCorrection(ndat_per_weight=512)
        lo, hi = tb.level_tables
        i = int(round(512 * optimal_flow()))
        f = i / 512  # tables normalize at the block's own observed fraction
        var = f * lo[i] ** 2 + (1 - f) * hi[i] ** 2
        assert abs(var - 1.0) < 1e-5

    def test_two_bit_unpack_gaussian(self, rng):
        """Quantize a Gaussian to 2 bits, unpack, check variance and
        correlation; all weights good."""
        n = 512 * 64
        x = rng.standard_normal(n)
        t = 0.9674
        codes = np.digitize(x, [-t, 0, t])  # 0..3 offset-binary-like
        # pack 4 codes/byte MSB first
        c = codes.reshape(-1, 4)
        raw = (c[:, 0] << 6 | c[:, 1] << 4 | c[:, 2] << 2 | c[:, 3]).astype(np.uint8)

        tb = TwoBitCorrection(ndat_per_weight=512)
        lo, hi = tb.level_tables
        y, w = unpack_twobit_dynamic(
            jnp.asarray(raw), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(tb.weight_table), 1, 1, 1, 512)
        y = np.asarray(y).ravel()
        w = np.asarray(w)
        assert w.shape == (1, 64)
        assert w.min() == 1.0  # clean Gaussian: nothing excised
        assert abs(np.var(y) - 1.0) < 0.02
        assert np.corrcoef(x, y)[0, 1] > 0.85  # JA98 2-bit efficiency ~0.88

    def test_excision_flags_interference(self, rng):
        """Blocks with saturating interference get weight 0."""
        n = 512 * 8
        x = rng.standard_normal(n)
        x[512 * 3 : 512 * 4] = 50.0  # all samples high -> nlow ~ 0
        t = 0.9674
        codes = np.digitize(x, [-t, 0, t])
        c = codes.reshape(-1, 4)
        raw = (c[:, 0] << 6 | c[:, 1] << 4 | c[:, 2] << 2 | c[:, 3]).astype(np.uint8)
        tb = TwoBitCorrection(ndat_per_weight=512)
        lo, hi = tb.level_tables
        _, w = unpack_twobit_dynamic(
            jnp.asarray(raw), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(tb.weight_table), 1, 1, 1, 512)
        w = np.asarray(w)[0]
        assert w[3] == 0.0
        assert w[[0, 1, 2, 4, 5, 6, 7]].min() == 1.0


class TestHistogram:
    def test_counts(self):
        raw = jnp.asarray(np.array([0b11100100, 0b11111111], np.uint8))
        h = np.asarray(digitizer_histogram(raw, 2))
        np.testing.assert_array_equal(h, [1, 1, 1, 5])
