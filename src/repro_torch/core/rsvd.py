"""Randomized SVD (paper Algorithm 1) with mixed-precision random projection
(port of the one-shot part of ``repro/core/rsvd.py``).

The random projection (line 1, the O(mnp) term) is the paper's target and
runs through ``projection.sketch``; QR (line 2), B = Q^T A (line 3), the
small SVD (line 4) and the back-projection (line 5) run in f32 through
``torch.linalg`` and ``torch.matmul`` (TF32 off), as the reference leaves
them to XLA.  The test-matrix builders draw from an explicit
``torch.Generator`` on the device where the matrix is wanted.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import projection as proj
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels.ref import dot_f32 as _dot


class SVDResult(NamedTuple):
    u: torch.Tensor      # (m, rank)
    s: torch.Tensor      # (rank,)
    vt: torch.Tensor     # (rank, n)


def _check_rank(rank: int, m: int, n: int) -> None:
    """A rank above min(m, n) would be silently absorbed by the sketch-width
    clamp and return an under-ranked factorization: raise instead."""
    if not 1 <= rank <= min(m, n):
        raise ValueError(
            f"rank={rank} is out of range for a {m}x{n} matrix: need "
            f"1 <= rank <= min(m, n) = {min(m, n)} — the sketch-width clamp "
            f"would otherwise silently return only min(m, n) columns")


def rsvd(key, a, rank: int, *, oversample: int = 10, power_iters: int = 0,
         method: proj.ProjectionMethod = "shgemm",
         dist: proj.SketchDist = "gaussian", omega_dtype=torch.bfloat16,
         device=None) -> SVDResult:
    """p-rank randomized SVD of ``a`` (paper Algorithm 1); sketch width
    p_hat = rank + oversample; ``power_iters`` f32 power iterations."""
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    m, n = a.shape
    _check_rank(rank, m, n)
    p_hat = min(rank + oversample, min(m, n))

    # Line 1: Y = A . Omega — THE mixed-precision projection.
    y = proj.sketch(key, a, p_hat, method=method, dist=dist,
                    omega_dtype=omega_dtype, device=dev)
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(y)
        z = _dot(a.T, q)
        q, _ = torch.linalg.qr(z)
        y = _dot(a, q)
    q, _ = torch.linalg.qr(y)                                    # line 2
    b = _dot(q.T, a)                                             # line 3
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)        # line 4
    u = _dot(q, u_b)                                             # line 5
    return SVDResult(u[:, :rank], s[:rank], vt[:rank, :])


def range_finder(key, a, rank: int, *, oversample: int = 10,
                 method: proj.ProjectionMethod = "shgemm",
                 dist: proj.SketchDist = "gaussian",
                 omega_dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Return Q with orthonormal columns s.t. A ~ Q Q^T A (Eq. 3)."""
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    m, n = a.shape
    _check_rank(rank, m, n)
    p_hat = min(rank + oversample, min(m, n))
    y = proj.sketch(key, a, p_hat, method=method, dist=dist,
                    omega_dtype=omega_dtype, device=dev)
    q, _ = torch.linalg.qr(y)
    return q


def projection_error(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """||A - Q Q^T A||_F — the Fig. 3 / Eq. 4 quantity."""
    a = a.to(torch.float32)
    return torch.linalg.norm(a - _dot(q, _dot(q.T, a)))


def reconstruction_error(a: torch.Tensor, res: SVDResult) -> torch.Tensor:
    """Relative residual ||A - U S V^T||_F / ||A||_F (Fig. 7 metric)."""
    a = a.to(torch.float32)
    approx = _dot(res.u * res.s[None, :], res.vt)
    return torch.linalg.norm(a - approx) / torch.linalg.norm(a)


def halko_bound(s_tail_norm, rank: int, oversample: int):
    """Expected-error bound Eq. (4): sqrt(1 + p/(s-1)) * ||Sigma_2||_F.
    Needs oversample >= 2: Eq. (4)'s expectation runs over s-1 degrees of
    freedom and diverges at s = 1."""
    if oversample < 2:
        raise ValueError(
            f"halko_bound needs oversample >= 2 (Eq. 4's expectation runs "
            f"over s-1 degrees of freedom and diverges at s=1; below that "
            f"the sqrt argument is negative), got oversample={oversample}")
    return math.sqrt(1.0 + rank / (oversample - 1.0)) * s_tail_norm


def nystrom_eigh(key, a, rank: int, *, oversample: int = 10,
                 method: proj.ProjectionMethod = "shgemm",
                 omega_dtype=torch.bfloat16,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Randomized Nystrom eigendecomposition of a PSD matrix:
    Y = A Omega (nu-shifted), C = chol(Omega^T Y), B = Y C^-T,
    SVD(B) -> U, lam = sig^2 - nu."""
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    n = a.shape[0]
    _check_rank(rank, n, a.shape[1])
    p_hat = min(rank + oversample, n)
    # Nystrom reuses Omega downstream, so it must exist in memory; with the
    # fused method the hot GEMM still skips the Omega reads.
    if method == "shgemm_fused":
        omega = proj.fused_omega(key, (n, p_hat), dtype=omega_dtype, device=dev)
    else:
        omega = proj.materialize_omega(key, (n, p_hat), dtype=omega_dtype,
                                       device=dev)
    y = proj.sketch(key, a, p_hat, method=method, omega_dtype=omega_dtype,
                    device=dev)
    nu = math.sqrt(n) * 1e-6 * torch.linalg.norm(y)
    y = y + nu * omega.to(torch.float32)
    g = _dot(omega.T, y)
    g = 0.5 * (g + g.T)
    c = torch.linalg.cholesky(g)
    b = torch.linalg.solve_triangular(c, y.T, upper=False).T
    u, sig, _ = torch.linalg.svd(b, full_matrices=False)
    lam = torch.clamp(sig**2 - nu, min=0.0)
    return u[:, :rank], lam[:rank]


# ---------------------------------------------------------------------------
# Test-matrix generators (paper §5.1.1 and §3.3), on a torch.Generator
# ---------------------------------------------------------------------------

def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def matrix_with_singular_values(gen: torch.Generator, n: int,
                                s_vals: torch.Tensor) -> torch.Tensor:
    """Random n x n matrix U diag(s) V^T with Haar-ish U, V from QR of
    Gaussians drawn from ``gen`` (on ``gen.device``)."""
    u, _ = torch.linalg.qr(_randn(gen, (n, n)))
    v, _ = torch.linalg.qr(_randn(gen, (n, n)))
    return _dot(u * s_vals.to(u.device)[None, :], v.T)


def singular_values_linear(n: int, p: int, s_p: float,
                           device=None) -> torch.Tensor:
    """A_linear spectrum: s_i = max(-alpha_l * i + 1, s_p), alpha_l=(1-s_p)/p."""
    i = torch.arange(n, dtype=torch.float32, device=resolve_device(device))
    alpha = (1.0 - s_p) / p
    return torch.clamp(-alpha * i + 1.0, min=s_p)


def singular_values_exp(n: int, p: int, s_p: float, device=None) -> torch.Tensor:
    """A_exp spectrum: s_i = 2^(-alpha_e * i), alpha_e = log2(1/s_p)/p."""
    dev = resolve_device(device)
    i = torch.arange(n, dtype=torch.float32, device=dev)
    alpha = torch.log2(torch.tensor(1.0 / s_p, dtype=torch.float32,
                                    device=dev)) / p
    return torch.exp2(-alpha * i)


def matrix_type1(gen: torch.Generator, n: int = 4096, r: int = 20,
                 xi: float = 1e-4) -> torch.Tensor:
    """§3.3 Type 1: D + xi * G G^T / n with D = diag(I_r, 0)."""
    g = _randn(gen, (n, n))
    d = torch.zeros(n, dtype=torch.float32, device=g.device)
    d[:r] = 1.0
    return torch.diag(d) + xi * _dot(g, g.T) / n


def matrix_type2(gen: torch.Generator, n: int = 4096, r: int = 20,
                 alpha: float = 3.0, phi: float = 1e6) -> torch.Tensor:
    """§3.3 Type 2 (= A_poly): U diag(phi*I_r, 2^-a, 3^-a, ...) V^T."""
    head = torch.full((r,), phi, dtype=torch.float32, device=gen.device)
    tail = torch.arange(2, n - r + 2, dtype=torch.float32,
                        device=gen.device) ** (-alpha)
    return matrix_with_singular_values(gen, n, torch.cat([head, tail]))


def matrix_cauchy(gen: torch.Generator, n: int = 4096,
                  gamma: float = 1e-3) -> torch.Tensor:
    """§5.1.1 Cauchy matrix: 1/(|x_i - y_j| + gamma), x,y ~ U(-1e-3, 1e-3)."""
    def unif(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
        return u * 2e-3 - 1e-3
    x = unif((n, 1))
    y = unif((1, n))
    return 1.0 / (torch.abs(x - y) + gamma)
