"""core/gaussian.py: the port's numpy-only copy of the paper's §3.1-3.2
analysis (Table 1, the rounded-Gaussian variance of Fig. 2, the RN
quantizer of Fig. 3) against the reference, by exact equality."""

import math

import numpy as np
import pytest

from repro.core import gaussian as ref_g
from repro_torch.core import gaussian as g

NAMES = ["FP8_E4M3", "FP8_E5M2", "FP16", "BF16", "TF32", "FP32"]


@pytest.mark.parametrize("name", NAMES)
def test_format_properties_equal_reference(name):
    got, want = getattr(g, name), getattr(ref_g, name)
    for prop in ("name", "exp_bits", "mant_bits", "bias", "max_value",
                 "min_normal", "min_denormal", "unit_roundoff"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("name", NAMES)
def test_table1_quantities_equal_reference(name):
    got, want = getattr(g, name), getattr(ref_g, name)
    for fn in ("overflow_log10_prob", "underflow_prob", "not_normalized_prob"):
        assert getattr(g, fn)(got) == getattr(ref_g, fn)(want), fn
    for s in range(4):
        assert (g.count_within_sigma_range(got, s)
                == ref_g.count_within_sigma_range(want, s))


# The variance enumerates every value of the format below 2^8, so only the
# formats of the paper's Fig. 2 (a few thousand values, not 10^9).
@pytest.mark.parametrize("name", ["FP8_E4M3", "FP8_E5M2", "FP16", "BF16"])
def test_rounded_gaussian_variance_equals_reference(name):
    assert (g.rounded_gaussian_variance(getattr(g, name))
            == ref_g.rounded_gaussian_variance(getattr(ref_g, name)))


def test_table1_equals_reference():
    assert g.table1() == ref_g.table1()


@pytest.mark.parametrize("x", [0.0, 0.5, 3.0, 29.9, 30.0, 500.0])
def test_tail_helpers_equal_reference(x):
    assert (g.log10_gaussian_two_sided_tail(x)
            == ref_g.log10_gaussian_two_sided_tail(x))
    assert g.gaussian_central_mass(x) == ref_g.gaussian_central_mass(x)


@pytest.mark.parametrize("name", NAMES)
def test_round_to_format_equals_reference(name):
    x = np.random.default_rng(0).standard_normal(4096) * 10.0 ** np.linspace(-9, 6, 4096)
    x[:3] = (0.0, 1e40, -1e-45)
    np.testing.assert_array_equal(g.round_to_format(x, getattr(g, name)),
                                  ref_g.round_to_format(x, getattr(ref_g, name)))


@pytest.mark.parametrize("bits", [2, 3, 7, 10])
def test_round_to_mantissa_equals_reference(bits):
    x = np.random.default_rng(bits).standard_normal(1000)
    np.testing.assert_array_equal(g.round_to_mantissa(x, bits),
                                  ref_g.round_to_mantissa(x, bits))
    assert np.all(np.isfinite(g.round_to_mantissa(x, bits)))
    assert math.isclose(float(np.abs(g.round_to_mantissa(x, bits) - x).max()),
                        float(np.abs(ref_g.round_to_mantissa(x, bits) - x).max()))
