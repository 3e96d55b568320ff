"""Structured random-projection families on the counter lattice (port of
``repro/core/structured.py``).

The Gaussian/Achlioptas/very-sparse Omegas are unstructured: every entry is
an independent draw, and applying one costs a full GEMM.  The two families
here keep the fused stream's determinism contract (every Omega element is a
pure function of ``(key, global row, col)``) while cutting the apply cost:

  * **SRHT**: ``Omega = D . H_L . S / sqrt(p)`` with ``D`` a random +-1
    diagonal (counter-hashed per row, stream 4), ``H_L`` the unnormalized
    Sylvester-Hadamard matrix of length ``L = next_pow2(n)`` and ``S`` a
    with-replacement column subsample (each sketch column hashes its own
    Hadamard column index, stream 5).  The apply path is sign flip + FWHT +
    gather: O(m.L.log L) adds, no GEMM, no (n x p) matrix.  The 1/sqrt(p)
    scale ties every entry to the total sketch width, which is why
    ``stream.SketchState.widen`` refuses the family.
  * **Khatri-Rao** ("Tensorized Random Projections", arXiv 2003.05101): the
    mode-i test matrix of a tensor is the column-wise Kronecker product of
    small per-mode Gaussian factors, so the mode-i sketch contracts the
    tensor factor by factor and nothing with the unfolding's column
    dimension ever exists.

Also here: the per-family estimator-validity table that gates the adaptive
driver's Halko Eq. (4) diagnostic (``core/rsvd.py``).

Departures from the reference: keys are the reference's key words, held as
a pair of ints (``kernels/shgemm_fused.key_pair``); ``popcount`` is an int64
SWAR count standing in for ``jax.lax.population_count``; the FWHT and the
Khatri-Rao contractions are plain PyTorch on whatever device the operand
lives on (the reference computes them in plain ``jnp`` too, outside any
Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import shgemm_fused as _kf

# Counter-hash draw streams (the unstructured dists use 0/1; SRHT claims its
# own so the sign diagonal and the column subsample never alias them).
SRHT_SIGN_STREAM = 4
SRHT_INDEX_STREAM = 5

STRUCTURED_DISTS = ("srht", "khatri_rao")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (the SRHT transform length)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word held in an int64 tensor (SWAR count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


# ---------------------------------------------------------------------------
# Fast Walsh-Hadamard transform
# ---------------------------------------------------------------------------

def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform along the last axis, in f32.

    Sylvester (natural) order: ``out[..., i] = sum_j (-1)^popcount(i & j)
    x[..., j]``, the sign convention ``srht_omega`` materializes.  Length
    must be a power of two; O(L log L) additions, no multiplies.
    """
    lead = x.shape[:-1]
    L = x.shape[-1]
    if L & (L - 1):
        raise ValueError(f"fwht length must be a power of two, got {L}")
    x = x.to(torch.float32).reshape(-1, L)
    h = 1
    while h < L:
        x = x.reshape(-1, L // (2 * h), 2, h)
        a = x[:, :, 0, :]
        b = x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2).reshape(-1, L)
        h *= 2
    return x.reshape(*lead, L)


# ---------------------------------------------------------------------------
# SRHT
# ---------------------------------------------------------------------------

def srht_signs(key, rows: torch.Tensor) -> torch.Tensor:
    """+-1 diagonal entries D[row], f32: a pure function of (key, global
    row)."""
    k0, k1 = _kf.key_pair(key)
    bits = _kf.counter_bits(k0, k1, rows.to(torch.int64),
                            torch.zeros((), dtype=torch.int64,
                                        device=rows.device),
                            SRHT_SIGN_STREAM)
    one = torch.ones((), dtype=torch.float32, device=rows.device)
    return torch.where((bits >> 31).bool(), -one, one)


def srht_col_indices(key, cols: torch.Tensor, L: int) -> torch.Tensor:
    """Hadamard column index idx(col) in [0, L), int64: a pure function of
    (key, global col).  L is a power of two, so the uint32 modulo (a mask)
    is exactly uniform."""
    k0, k1 = _kf.key_pair(key)
    bits = _kf.counter_bits(k0, k1,
                            torch.zeros((), dtype=torch.int64,
                                        device=cols.device),
                            cols.to(torch.int64), SRHT_INDEX_STREAM)
    return bits & (L - 1)


def srht_omega(key, shape: tuple[int, int], *, n_total: int | None = None,
               p_total: int | None = None, row_offset: int = 0,
               col_offset: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Dense (rows, cols) block of the SRHT Omega: the oracle the apply path
    is tested against, and the block-regeneration primitive of partial-width
    streamed tiles (``stream.update_cols``).

    ``Omega[i, j] = D[i] . (-1)^popcount(i & idx(j)) / sqrt(p_total)`` on
    global indices.  ``n_total`` (the transform's data dimension, L =
    next_pow2) and ``p_total`` (the total sketch width) default to this
    block's shape.
    """
    dev = resolve_device(device)
    n, p = shape
    L = next_pow2(n_total if n_total is not None else n)
    p_tot = int(p_total) if p_total is not None else p
    rows = (torch.arange(n, dtype=torch.int64, device=dev)[:, None]
            + int(row_offset))
    cols = (torch.arange(p, dtype=torch.int64, device=dev)[None, :]
            + int(col_offset))
    d = srht_signs(key, rows)                       # (n, 1)
    idx = srht_col_indices(key, cols, L)            # (1, p)
    h = 1 - 2 * (popcount((rows & _kf._MASK) & idx) & 1)
    scale = torch.tensor(np.float32(1.0 / math.sqrt(p_tot)), device=dev)
    return (d * h.to(torch.float32) * scale).to(dtype)


def srht_sketch(key, a, p: int, *, device=None) -> torch.Tensor:
    """Y = A . Omega_srht(key)[n, p] without a GEMM: sign-flip the columns,
    FWHT each row, gather the p hashed Hadamard columns, scale by 1/sqrt(p).

    Row-local (row i of Y depends on row i of A alone), so streamed row
    tiles give the one-shot sketch's rows bit for bit.  Matches
    ``A @ srht_omega(key, (n, p))`` to f32 rounding.
    """
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    m, n = a.shape
    L = next_pow2(n)
    d = srht_signs(key, torch.arange(n, dtype=torch.int64, device=dev))
    x = a * d[None, :]
    if L > n:
        x = torch.nn.functional.pad(x, (0, L - n))
    x = fwht(x)
    idx = srht_col_indices(key, torch.arange(p, dtype=torch.int64,
                                             device=dev), L)
    scale = torch.tensor(np.float32(1.0 / math.sqrt(p)), device=dev)
    return torch.index_select(x, 1, idx) * scale


def srht_apply_flops(m: int, n: int, p: int) -> int:
    """Adds of the apply path (sign flips + FWHT butterflies + gather),
    against the 2.m.n.p FLOPs of the GEMM it replaces."""
    L = next_pow2(n)
    return m * n + m * L * int(math.log2(L)) + m * p


# ---------------------------------------------------------------------------
# Khatri-Rao (tensorized) Omega
# ---------------------------------------------------------------------------

# Shape log installed by ``record_shapes``: every intermediate of
# ``KhatriRaoOmega.sketch_slab`` appends its shape (the "never materializes
# the unfolding's column dimension" probe).
_SHAPE_LOG: Optional[list] = None


class record_shapes:
    """Context manager installing a shape log for Khatri-Rao sketch
    intermediates:

        with structured.record_shapes() as shapes:
            ...khatri_rao sketches...
        assert all(math.prod(s[1:-1]) < unfolding_cols for s in shapes)
    """

    def __init__(self, log: list | None = None):
        self.log = log if log is not None else []

    def __enter__(self) -> list:
        global _SHAPE_LOG
        self._prev = _SHAPE_LOG
        _SHAPE_LOG = self.log
        return self.log

    def __exit__(self, *exc):
        global _SHAPE_LOG
        _SHAPE_LOG = self._prev
        return False


def _probe(shape) -> None:
    if _SHAPE_LOG is not None:
        _SHAPE_LOG.append(tuple(int(s) for s in shape))


_KR_SALT_A = 0x8EBC6AF1
_KR_SALT_B = 0x5851F42D


@dataclasses.dataclass(frozen=True)
class KhatriRaoOmega:
    """Mode-``mode`` Khatri-Rao test matrix of a ``dims`` tensor, width
    ``p``: the column-wise Kronecker product of per-mode Gaussian factors
    ``f_j (I_j, p)`` for ``j != mode``, each on the counter lattice under a
    hash-fold of the key (every factor element is a pure function of
    ``(key, j, row, col)``).  Rows of the implied dense Omega follow
    ``hosvd.unfold``: non-mode axes ascending, row-major.  ``key`` is the
    key words; the factors are made on ``device`` (CUDA unless "cpu")."""
    key: tuple
    dims: tuple
    mode: int
    p: int
    device: object = None

    def __post_init__(self):
        if not 0 <= self.mode < len(self.dims):
            raise ValueError(f"mode {self.mode} out of range for dims "
                             f"{self.dims}")
        if len(self.dims) < 2:
            raise ValueError("Khatri-Rao Omega needs a tensor (ndim >= 2); "
                             "matrix sketches have nothing to factor")

    @property
    def others(self) -> tuple[int, ...]:
        return tuple(j for j in range(len(self.dims)) if j != self.mode)

    @property
    def n_cols(self) -> int:
        return math.prod(self.dims[j] for j in self.others)

    def _factor_words(self, j: int) -> tuple[int, int]:
        k0, k1 = _kf.key_pair(self.key)
        kw = torch.tensor([(k0 + j * _KR_SALT_A) & _kf._MASK,
                           k1 ^ ((j * _KR_SALT_B) & _kf._MASK)],
                          dtype=torch.int64)
        return tuple(int(w) for w in _kf._fmix32(kw).tolist())

    def factor(self, j: int, rows: int | None = None,
               row_offset: int = 0) -> torch.Tensor:
        """Factor ``f_j`` rows [row_offset : row_offset+rows] from the
        counter lattice, f32 (the factors are small; only the big mode GEMMs
        they replace were mixed-precision)."""
        if j == self.mode:
            raise ValueError(f"mode {j} is the sketched mode; the "
                             f"Khatri-Rao product runs over the others")
        r = int(rows) if rows is not None else self.dims[j]
        return _kf.reference_omega(self._factor_words(j), (r, self.p),
                                   dist="gaussian", dtype=torch.float32,
                                   row_offset=row_offset, device=self.device)

    def sketch_slab(self, slab, axis0_offset: int = 0) -> torch.Tensor:
        """Contribution of an axis-0 slab ``A[off:off+b, ...]`` to the mode
        sketch ``W = A_(mode) . Omega_mode``, contracted factor by factor.

        ``mode == 0``: the slab's rows of W, (b, p).  Otherwise a full-shape
        partial sum (I_mode, p) with factor 0's rows regenerated at
        ``axis0_offset``.  The largest remaining axis is contracted first
        (smallest intermediates); each intermediate goes to the
        ``record_shapes`` probe.
        """
        t = on_device(slab, resolve_device(self.device)).to(torch.float32)
        if t.ndim != len(self.dims):
            raise ValueError(f"slab ndim {t.ndim} != tensor ndim "
                             f"{len(self.dims)}")
        for j in range(len(self.dims)):
            if j not in (0, self.mode) and t.shape[j] != self.dims[j]:
                raise ValueError(f"slab axis {j} has {t.shape[j]} != "
                                 f"dims[{j}]={self.dims[j]} (slabs tile "
                                 f"axis 0 only)")
        order = sorted(self.others, key=lambda j: -t.shape[j])
        cur = t.permute((self.mode,) + tuple(order))
        first = True
        for j in order:
            f = self.factor(j, rows=cur.shape[1],
                            row_offset=(axis0_offset if j == 0 else 0))
            if first:
                cur = torch.einsum("ma...,ap->m...p", cur, f)
                first = False
            else:
                cur = torch.einsum("ma...p,ap->m...p", cur, f)
            _probe(cur.shape)
        return cur  # (slab mode extent, p)

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        """Materialized (prod_{j != mode} I_j, p) Omega, rows ordered as
        ``hosvd.unfold``'s columns: the oracle GEMM operand (tests only)."""
        out = torch.ones((1, self.p), dtype=torch.float32,
                         device=resolve_device(self.device))
        for j in self.others:
            f = self.factor(j)
            out = (out[:, None, :] * f[None, :, :]).reshape(-1, self.p)
        return out.to(dtype)


# ---------------------------------------------------------------------------
# Per-family estimator validity (Pearce-Martinsson survey, arXiv 2512.05286)
# ---------------------------------------------------------------------------

_GAUSS_ONLY = ("the Halko Eq. (4) expected-error bound is a theorem about "
               "GAUSSIAN test matrices (Halko et al. 2011, Thm. 10.5 takes "
               "the expectation over a Gaussian Omega); {family} matrices "
               "obey different, larger-constant tail bounds (see the "
               "Pearce–Martinsson survey), so the Eq.-4 number would be "
               "reported as if it certified an error it does not — the "
               "exact posterior estimate ||A||² − Σσ²(QᵀA) remains valid "
               "for every family and is what drives the widening loop")

#: family -> which error estimators are valid.  ``posterior_exact`` is the
#: adaptive driver's stopping rule (exact for any orthonormal Q);
#: ``halko_eq4`` the Gaussian-specific Eq. (4) prior bound.
ESTIMATOR_VALIDITY = {
    "gaussian": {"posterior_exact": True, "halko_eq4": True,
                 "reason": None},
    "achlioptas": {"posterior_exact": True, "halko_eq4": False,
                   "reason": _GAUSS_ONLY.format(family="sparse-sign")},
    "very_sparse": {"posterior_exact": True, "halko_eq4": False,
                    "reason": _GAUSS_ONLY.format(family="very-sparse sign")},
    "srht": {"posterior_exact": True, "halko_eq4": False,
             "reason": _GAUSS_ONLY.format(family="SRHT")},
    "khatri_rao": {"posterior_exact": True, "halko_eq4": False,
                   "reason": _GAUSS_ONLY.format(family="Khatri–Rao")},
}


def halko_bound_valid(dist: str) -> bool:
    """True iff the Eq.-4 diagnostic may be reported for ``dist``."""
    try:
        return ESTIMATOR_VALIDITY[dist]["halko_eq4"]
    except KeyError:
        raise ValueError(f"unknown sketch distribution {dist!r}") from None


def bound_invalid_reason(dist: str) -> str | None:
    """Documented reason the Eq.-4 bound is withheld (None when valid)."""
    halko_bound_valid(dist)  # raise on unknown family
    return ESTIMATOR_VALIDITY[dist]["reason"]
