"""Mixed-precision random projection, the paper's core primitive (port of
``repro/core/projection.py``).

``Y = A @ Omega`` with A in f32 and Omega stored in a low-precision format.
Methods (the reference's names):

  * ``f32``           — baseline: f32 ``torch.matmul`` (TF32 off).
  * ``lowp_single``   — both operands rounded to bf16, one pass, f32
                        accumulation: fast but lossy (paper Fig. 7).
  * ``shgemm``        — the paper's method in plain PyTorch: A split hi+lo,
                        two passes, f32 accumulation (Eq. 40).
  * ``shgemm3``       — 3-term bf16 split, f32-level accuracy.
  * ``shgemm_pallas`` — the same math through hand-written kernel 1.
  * ``shgemm_fused``  — kernel 2: Omega generated in-kernel from a key; use
                        ``sketch`` (key-based) to get that benefit.
                        ``project`` with this method runs kernel 1.

The low-precision methods upcast their exact bf16/fp16 terms to f32 before
``torch.matmul``: a bf16-output product would round each term.

Documented deviation from the reference: the reference draws the legacy
(non-fused) Omega with ``jax.random`` (threefry and jax's normal
transform), which torch cannot reproduce.  The port draws every
distribution from the fused kernel's counter lattice instead, whose uint32
bits are exact on any backend (reference DESIGN.md §9 items 1-2) and stable
across releases (§4.2).  So here ``materialize_omega`` equals
``fused_omega`` for every dist, and a key gives the same Omega to every
method.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core import structured as _sx
from repro_torch.core.splitting import FP16_INV_SCALE, split_fp32, split_fp32_bf16_3
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm_fused as _f
from repro_torch.kernels.ref import dot_f32

ProjectionMethod = Literal["f32", "lowp_single", "shgemm", "shgemm3",
                           "shgemm_pallas", "shgemm_fused"]
SketchDist = Literal["gaussian", "achlioptas", "very_sparse", "srht"]

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


# ---------------------------------------------------------------------------
# Random matrix generation (all on the counter lattice; see module docstring)
# ---------------------------------------------------------------------------

def gaussian(key, shape: tuple[int, int], dtype=torch.bfloat16,
             device=None) -> torch.Tensor:
    """N(0,1) Gaussian matrix from the counter lattice (Box–Muller in f32),
    RN-rounded to ``dtype``.  Paper §3.2: the rounded matrix has variance
    alpha_Y != 1, but the Halko bound is variance-invariant."""
    return _f.reference_omega(key, shape, dist="gaussian", dtype=dtype,
                              device=device)


def gaussian_fp8(key, shape: tuple[int, int], variant: str = "e4m3",
                 device=None) -> torch.Tensor:
    """fp8-stored Gaussian matrix (1/4 the memory of an f32 Omega): storage
    only, consumed as bf16 by ``project`` and kernel 2."""
    dt = torch.float8_e4m3fn if variant == "e4m3" else torch.float8_e5m2
    return gaussian(key, shape, dtype=dt, device=device)


def achlioptas_sparse(key, shape: tuple[int, int], s: float = 3.0,
                      dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Achlioptas sparse matrix, Eq. (5), without the sqrt(s) scale (paper
    §3.4): entries {-1, 0, +1}, exact in any format."""
    return _f.reference_omega(key, shape, dist="achlioptas", s=s, dtype=dtype,
                              device=device)


def very_sparse(key, shape: tuple[int, int], s: float | None = None,
                dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Li et al. very sparse projection: s = sqrt(n) with n the data
    dimension (Omega's row count) unless ``s`` is given."""
    return _f.reference_omega(key, shape, dist="very_sparse",
                              s=_f._resolve_s("very_sparse", s, shape[0]),
                              dtype=dtype, device=device)


def materialize_omega(key, shape: tuple[int, int], *,
                      dist: SketchDist = "gaussian", s: float | None = None,
                      dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """The Omega ``sketch`` feeds to ``project`` for ``dist`` (non-fused
    methods).  ``s`` overrides the sparse dists' sparsity.  For ``srht`` it
    is the dense lattice oracle of ``core/structured.py``, the matrix the
    O(n log n) apply path applies."""
    if dist == "gaussian":
        return gaussian(key, shape, dtype=dtype, device=device)
    if dist == "achlioptas":
        return achlioptas_sparse(key, shape, s=(3.0 if s is None else s),
                                 dtype=dtype, device=device)
    if dist == "very_sparse":
        return very_sparse(key, shape, s=s, dtype=dtype, device=device)
    if dist == "srht":
        return _sx.srht_omega(key, shape, dtype=dtype, device=device)
    raise ValueError(f"unknown sketch distribution {dist!r}")


def fused_omega(key, shape: tuple[int, int], *, dist: SketchDist = "gaussian",
                s: float | None = None, dtype=torch.bfloat16,
                device=None) -> torch.Tensor:
    """Materialize the exact Omega the fused kernel generates on chip."""
    return _f.reference_omega(key, shape, dist=dist, s=s, dtype=dtype,
                              device=device)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def shgemm_jnp(a_f32: torch.Tensor, b_lowp: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (37)-(40) in plain PyTorch: C = A_hi.B + A_lo.B, f32
    accumulation; fp16 applies the paper's 2^-11 scaling.  (The name is the
    reference's.)"""
    fmt = "fp16" if b_lowp.dtype == torch.float16 else "bf16"
    hi, lo = split_fp32(a_f32, fmt)
    main = dot_f32(hi, b_lowp)
    corr = dot_f32(lo, b_lowp)
    if fmt == "fp16":
        return main + corr * FP16_INV_SCALE
    return main + corr


def project(a, omega, method: ProjectionMethod = "shgemm",
            device=None) -> torch.Tensor:
    """Y = A @ Omega with the selected mixed-precision strategy."""
    dev = resolve_device(device)
    a = on_device(a, dev)
    omega = on_device(omega, dev)
    if omega.dtype in _FP8:
        # fp8 Omega is storage-only; consumed as bf16 (e8m7 superset of both)
        omega = omega.to(torch.bfloat16)
    if method == "f32":
        return dot_f32(a, omega)
    if method == "lowp_single":
        return dot_f32(a.to(torch.bfloat16), omega.to(torch.bfloat16))
    if method == "shgemm":
        return shgemm_jnp(a.to(torch.float32), omega)
    if method == "shgemm3":
        hi, mid, lo = split_fp32_bf16_3(a)
        b = omega.to(torch.bfloat16)
        return dot_f32(hi, b) + dot_f32(mid, b) + dot_f32(lo, b)
    if method in ("shgemm_pallas", "shgemm_fused"):
        # With a materialized Omega there is nothing left to fuse.
        return ops.shgemm(a.to(torch.float32), omega, device=dev)
    raise ValueError(f"unknown projection method {method!r}")


def sketch(key, a, p: int, *, method: ProjectionMethod = "shgemm",
           dist: SketchDist = "gaussian", s: float | None = None,
           omega_dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Y = A @ Omega(key)[a.shape[1], p] without the caller materializing
    Omega: the key-based front door for rsvd, hosvd and lstsq.

    ``dist="srht"`` runs the structured apply (sign flip + FWHT + gather,
    ``core/structured.py``), O(n log n) adds and no GEMM, whatever the
    method.  ``method="shgemm_fused"`` generates Omega inside kernel 2; any
    other method materializes it (``materialize_omega``) and calls
    ``project``.
    """
    dev = resolve_device(device)
    a = on_device(a, dev)
    if dist == "srht":
        return _sx.srht_sketch(key, a, p, device=dev)
    if method == "shgemm_fused":
        return ops.shgemm_fused(a.to(torch.float32), key, p, dist=dist, s=s,
                                omega_dtype=omega_dtype, device=dev)
    omega = materialize_omega(key, (a.shape[1], p), dist=dist, s=s,
                              dtype=omega_dtype, device=dev)
    return project(a, omega, method=method, device=dev)
