"""The algorithm's work, reckoned from shapes alone, and the card's peaks.

What these count does not change with the implementation: a projection
Y = A . Omega of (m, n) @ (n, p) does 2 m n p operations, reads A once and
writes Y once (Omega is a function of the key, so its bytes are not the
algorithm's).  A decomposition's operations are the textbook counts of its
steps: Householder QR of an m x p matrix with Q formed, 4 m p^2 - 4/3 p^3
(LAPACK's geqrf and orgqr); the thin SVD of a p x n matrix (p <= n) with U,
s and V^T by R-SVD, 6 n p^2 + 20 p^3 (Golub and Van Loan, table 5.4.1); a
product of (a, b) @ (b, c), 2 a b c.
"""

from __future__ import annotations

import math

from bench import inputs

# NVIDIA H100 SXM data sheet, dense: the bf16 / fp16 tensor-core peak and
# the HBM3 bandwidth, at the card's 700 W limit.
PEAK_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12


def gemm_flops(a: int, b: int, c: int) -> float:
    return 2.0 * a * b * c


def qr_flops(m: int, p: int) -> float:
    return 4.0 * m * p * p - 4.0 / 3.0 * p ** 3


def svd_flops(p: int, n: int) -> float:
    p, n = min(p, n), max(p, n)
    return 6.0 * n * p * p + 20.0 * p ** 3


def projection_bound_s(m: int, n: int, p: int) -> float:
    """Least time of Y = A . Omega on the card: the larger of its
    operations over the tensor-core peak and A's and Y's f32 bytes over the
    memory rate."""
    return max(gemm_flops(m, n, p) / PEAK_FLOP_PER_S,
               (4.0 * m * n + 4.0 * m * p) / PEAK_BYTES_PER_S)


def sketches(entry: str, config: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """(m, n, p) of every projection one decomposition makes, in order
    (the power iterations' products are dense f32, not projections)."""
    if entry == "rsvd":
        m = n = config["n"]
        p = min(config["rank"] + config["oversample"], m, n)
        return [(m, n, p)]
    dims, ranks = list(config["dims"]), inputs.hosvd_ranks(config)
    out = []
    for i in range(len(dims)):
        rest = math.prod(d for j, d in enumerate(dims) if j != i)
        out.append((dims[i], rest, ranks[i]))
        if entry == "rp_sthosvd":
            dims[i] = ranks[i]
    return out


def projection_bound_per_decomp_s(entry: str, config: dict,
                                  traffic: dict) -> float:
    return sum(projection_bound_s(*s) for s in sketches(entry, config, traffic))


def decomp_flops(entry: str, config: dict, traffic: dict) -> float:
    """Textbook operations of one decomposition."""
    if entry == "rsvd":
        m = n = config["n"]
        p = min(config["rank"] + config["oversample"], m, n)
        q = traffic.get("power_iters", 0)
        sketch = gemm_flops(m, n, p)
        power = q * (2 * qr_flops(m, p) + 2 * gemm_flops(m, n, p))
        return (sketch + power + qr_flops(m, p) + gemm_flops(p, m, n)
                + svd_flops(p, n) + gemm_flops(m, p, p))
    dims, ranks = list(config["dims"]), inputs.hosvd_ranks(config)
    total = 0.0
    for (m, rest, p) in sketches(entry, config, traffic):
        total += gemm_flops(m, rest, p) + qr_flops(m, p)
    # the core: T x_1 Q_1^T ... x_N Q_N^T, each a (J_i, I_i) @ (I_i, rest)
    for i in range(len(dims)):
        rest = math.prod(d for j, d in enumerate(dims) if j != i)
        total += gemm_flops(ranks[i], dims[i], rest)
        dims[i] = ranks[i]
    return total
