"""Properties of Gaussian random values represented in low-precision floats
(the port's numpy-only copy of ``repro/core/gaussian.py``: the port imports
nothing of the reference package, so the analysis is repeated here).

Implements the paper's §3.1-3.2: for a float format eXmY (X exponent bits,
Y explicit mantissa bits, IEEE-like with denormals, RN rounding):

  * overflow / underflow / not-normalized probabilities (Table 1 top),
  * the number of representable values within the 2^s * sigma range (Eq. 18,
    Table 1 bottom),
  * the variance alpha_Y of an RN-rounded N(0,1) sample (Fig. 2) by exact
    enumeration of the format's values and their rounding intervals,
  * ``round_to_format`` — RN quantizer to an arbitrary eXmY format (used by the
    Fig. 3 mantissa-sweep experiment and the projection accuracy benchmark).

All of this is host-side analysis (numpy, not jax).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    name: str
    exp_bits: int  # X
    mant_bits: int  # Y (explicit bits, excluding the implicit leading 1)

    @property
    def bias(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def max_value(self) -> float:
        # Paper Eq. (15): 2^(2^(X-1)-1) * (2 - 2^-Y).  (The paper writes
        # (1 - 2^-(Y+1)) against 2^(2^X - 2 - bias); same number.)
        return 2.0 ** (2 ** (self.exp_bits - 1) - 1) * (2.0 - 2.0 ** -self.mant_bits)

    @property
    def min_normal(self) -> float:
        return 2.0 ** (2 - 2 ** (self.exp_bits - 1))

    @property
    def min_denormal(self) -> float:
        return self.min_normal * 2.0 ** -self.mant_bits

    @property
    def unit_roundoff(self) -> float:
        # u_Y = 2^-(Y+1) as in the paper.
        return 2.0 ** -(self.mant_bits + 1)


FP8_E4M3 = FloatFormat("FP8_1 (e4m3)", 4, 3)
FP8_E5M2 = FloatFormat("FP8_2 (e5m2)", 5, 2)
FP16 = FloatFormat("FP16 (e5m10)", 5, 10)
BF16 = FloatFormat("bfloat16 (e8m7)", 8, 7)
TF32 = FloatFormat("TF32 (e8m10)", 8, 10)
FP32 = FloatFormat("FP32 (e8m23)", 8, 23)

TABLE1_FORMATS = (FP8_E4M3, FP8_E5M2, FP16, BF16, TF32, FP32)


# ---------------------------------------------------------------------------
# Gaussian tail helpers (log-space; the tails here underflow float64).
# ---------------------------------------------------------------------------

def log10_gaussian_two_sided_tail(x: float) -> float:
    """log10( 2 * (1 - Phi(x)) ) for x >= 0, stable for huge x.

    Uses erfc for moderate x and the asymptotic expansion
    1-Phi(x) ~ phi(x)/x for large x.
    """
    if x <= 0:
        return math.log10(1.0)
    if x < 30.0:
        p = math.erfc(x / math.sqrt(2.0))  # = 2*(1 - Phi(x))
        return math.log10(p) if p > 0 else -math.inf
    # log(2 * phi(x)/x) = log 2 - x^2/2 - log(x) - 0.5 log(2 pi)
    ln = math.log(2.0) - x * x / 2.0 - math.log(x) - 0.5 * math.log(2.0 * math.pi)
    return ln / math.log(10.0)


def gaussian_central_mass(x: float) -> float:
    """2*(Phi(x) - 1/2) = P(|g| <= x), accurate for tiny x."""
    return math.erf(x / math.sqrt(2.0))


# ---------------------------------------------------------------------------
# Table 1 quantities
# ---------------------------------------------------------------------------

def overflow_log10_prob(fmt: FloatFormat) -> float:
    """log10 p_of = log10 2(1 - Phi(max_eXmY))   (Eq. 16)."""
    return log10_gaussian_two_sided_tail(fmt.max_value)


def underflow_prob(fmt: FloatFormat) -> float:
    """p_uf.  The paper's formula says 2(Phi(min_denormal) - 1/2) but its
    published Table 1 values are the ONE-sided Phi(x) - 1/2 (checked against
    every entry: e4m3 8e-4, e5m2 6e-6, fp16 2e-8 ...).  We reproduce the
    table."""
    return gaussian_central_mass(fmt.min_denormal) / 2.0


def not_normalized_prob(fmt: FloatFormat) -> float:
    """p_not-normalized, one-sided to match the paper's Table 1 (e4m3 6e-3,
    e5m2/fp16 2e-5); see underflow_prob note."""
    return gaussian_central_mass(fmt.min_normal) / 2.0


def count_within_sigma_range(fmt: FloatFormat, s: int) -> int:
    """N^{2^s sigma}: representable values v with |v| < 2^s, including
    denormals and zero.

    Note: the paper's Eq. (18) as printed (2*(s+bias+1)*2^Y + 1) does NOT
    reproduce the paper's own Table 1 numbers; counting denormals + the
    normalized binades below 2^s gives 2*(s+bias)*2^Y - 1, which matches every
    Table 1 entry (FP16: 30719/32767/34815, e4m3: 111/127/143, ...).  We
    implement the table.
    """
    return 2 * (s + fmt.bias) * 2 ** fmt.mant_bits - 1


# ---------------------------------------------------------------------------
# Variance of the rounded Gaussian (Fig. 2) — exact enumeration
# ---------------------------------------------------------------------------

def _positive_values(fmt: FloatFormat, max_exp_clip: int = 8) -> np.ndarray:
    """All positive representable values with exponent <= 2^max_exp_clip.

    Values above ~2^8 = 256 sigma carry no Gaussian mass; clipping keeps the
    enumeration small for e8 formats.
    """
    Y = fmt.mant_bits
    mant = np.arange(2**Y, dtype=np.float64)
    # Denormals: 2^(1-bias) * (m / 2^Y), m = 1..2^Y-1
    den = 2.0 ** (1 - fmt.bias) * (mant[1:] / 2.0**Y)
    # Normalized: exponents e = 1-bias .. min(2^X-2-bias, clip)
    e_lo = 1 - fmt.bias
    e_hi = min(2**fmt.exp_bits - 2 - fmt.bias, max_exp_clip)
    vals = [den]
    for e in range(e_lo, e_hi + 1):
        vals.append(2.0**e * (1.0 + mant / 2.0**Y))
    return np.concatenate(vals)


def rounded_gaussian_variance(fmt: FloatFormat) -> float:
    """alpha_Y = E[g_eXmY^2] for g ~ N(0,1) rounded with RN (paper Fig. 2).

    Exact: for each positive representable v, the RN pre-image is
    [(v_prev+v)/2, (v+v_next)/2); mass from Phi.  Symmetric in sign, and the
    0-bucket contributes nothing to the second moment.
    """
    from scipy.stats import norm  # local import; analysis-only dependency

    v = _positive_values(fmt)
    v = np.sort(v)
    lo_mid = np.empty_like(v)
    hi_mid = np.empty_like(v)
    lo_mid[0] = v[0] / 2.0  # boundary with the 0 bucket
    lo_mid[1:] = (v[:-1] + v[1:]) / 2.0
    hi_mid[:-1] = lo_mid[1:]
    # Top bucket: everything above the last midpoint rounds to v_max (mass ~0
    # after the exponent clip anyway).
    hi_mid[-1] = np.inf
    mass = norm.cdf(hi_mid) - norm.cdf(lo_mid)
    return float(2.0 * np.sum(v * v * mass))


# ---------------------------------------------------------------------------
# Generic RN quantizer (Fig. 3 experiment; arbitrary mantissa sweeps)
# ---------------------------------------------------------------------------

def round_to_format(x: np.ndarray, fmt: FloatFormat) -> np.ndarray:
    """Round float64/float32 values to eXmY with round-to-nearest-even.

    Handles denormals (reduced effective mantissa near min_normal) and
    overflow to +-inf, matching IEEE semantics closely enough for the paper's
    experiments.
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    xa = np.abs(x[nz])
    e = np.floor(np.log2(xa))
    e = np.maximum(e, 1 - fmt.bias)  # denormal clamp
    ulp = np.exp2(e - fmt.mant_bits)
    q = np.round(xa / ulp) * ulp  # np.round is round-half-even (RN)
    # Re-normalize: rounding can bump to the next binade (e.g. 1.1111.. -> 10.0)
    # which is fine because ulp of the higher binade is a superset grid.
    q = np.where(q > fmt.max_value, np.inf, q)
    q = np.where(q < fmt.min_denormal / 2, 0.0, q)
    out[nz] = np.sign(x[nz]) * q
    return out


def round_to_mantissa(x: np.ndarray, mant_bits: int) -> np.ndarray:
    """RN-round to ``mant_bits`` explicit mantissa bits, e8 exponent (no
    overflow/underflow in practice).  Used by the Fig. 3 mantissa sweep."""
    return round_to_format(x, FloatFormat(f"e8m{mant_bits}", 8, mant_bits))


def table1(formats: tuple[FloatFormat, ...] = TABLE1_FORMATS) -> dict:
    """Reproduce Table 1 as structured data (benchmarks print it)."""
    rows = {}
    for f in formats:
        rows[f.name] = {
            "log10_p_overflow": overflow_log10_prob(f),
            "p_underflow": underflow_prob(f),
            "p_not_normalized": not_normalized_prob(f),
            "N_1sigma": count_within_sigma_range(f, 0),
            "N_2sigma": count_within_sigma_range(f, 1),
            "N_4sigma": count_within_sigma_range(f, 2),
        }
    return rows
