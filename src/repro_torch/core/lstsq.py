"""Randomized least squares via mixed-precision sketching (port of
``repro/core/lstsq.py``).

Solves min_x ||A x - b||_2 for tall A (m >> n) by sketch-and-precondition:
a low-precision random sketch S A (the paper's projection, applied from the
left) gives a preconditioner R from QR(S A); CGLS on A R^-1 converges in
O(log 1/eps) steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import projection as proj
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels.ref import dot_f32 as _dot


class LstsqResult(NamedTuple):
    x: torch.Tensor
    residual: torch.Tensor
    iters: int


def sketch_precond_lstsq(key, a, b, *, sketch_factor: int = 4,
                         method: proj.ProjectionMethod = "shgemm",
                         iters: int = 30, device=None) -> LstsqResult:
    """Blendenpik-style solver with a mixed-precision Gaussian sketch:
    Y = Omega^T A computed as (A^T . Omega)^T with the projection."""
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    b = on_device(b, dev).to(torch.float32)
    m, n = a.shape
    c = min(sketch_factor * n, m)
    ya = proj.sketch(key, a.T, c, method=method, omega_dtype=torch.bfloat16,
                     device=dev).T
    _, r = torch.linalg.qr(ya)  # R: (n, n) preconditioner

    def solve_r(v):  # x = R^-1 v
        return torch.linalg.solve_triangular(r, v[:, None], upper=True)[:, 0]

    def solve_rt(v):  # v = R^-T v
        return torch.linalg.solve_triangular(r.T, v[:, None], upper=False)[:, 0]

    # CGLS on the preconditioned normal equations (A R^-1).
    x = torch.zeros(n, dtype=torch.float32, device=dev)
    res = b
    g = solve_rt(_dot(a.T, res))
    p = g
    gg = torch.dot(g, g)
    for _ in range(iters):
        ap = _dot(a, solve_r(p))
        alpha = gg / torch.clamp(torch.dot(ap, ap), min=1e-30)
        x = x + alpha * p
        res = res - alpha * ap
        g_new = solve_rt(_dot(a.T, res))
        gg_new = torch.dot(g_new, g_new)
        beta = gg_new / torch.clamp(gg, min=1e-30)
        p = g_new + beta * p
        g, gg = g_new, gg_new
    x = solve_r(x)
    return LstsqResult(x, torch.linalg.norm(_dot(a, x) - b), iters)
