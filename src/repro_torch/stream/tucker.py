"""Streaming ST-HOSVD: single-pass Tucker factorization of a tensor that
arrives as slabs along axis 0 (port of ``repro/stream/tucker.py``).

Two-sided sketch scheme (Sun, Guo, Luo, Tropp, Udell 2020 on the counter
lattice):

  * per mode i, a right sketch Y_i = A_(i) . Omega_i in a ``SketchState``.
    Omega_i has prod_{j!=i} I_j rows and is never materialized: an axis-0
    slab is a contiguous column range of every unfolding, i.e. an Omega_i
    row block, which kernel 2 regenerates at that row offset.  With
    ``dist="khatri_rao"`` the mode sketches are factor-by-factor
    contractions (``core.structured.KhatriRaoOmega.sketch_slab``) instead;
  * one small core sketch Z = A x_0 Psi_0 x_1 ... x_{N-1} Psi_{N-1}
    (s_0 x ... x s_{N-1}), accumulated per slab with Psi_0's column block
    drawn at the slab's row offset.

Finalize: Q_i = orth(Y_i); core solved from Z via per-mode pinv(Psi_i Q_i).
Linear in A throughout, so ``tucker_merge`` combines disjoint slab sets.

Departures from the reference: per-mode Omega and Psi keys come from
``stream.state.fold_in_words`` (counter lattice stream 8), not
``jax.random.fold_in``; updates change the sketch in place and return it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import projection as proj
from repro_torch.core import structured as _sx
from repro_torch.core.hosvd import TuckerResult, mode_dot, unfold
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import shgemm_fused as _kf
from repro_torch.kernels.ref import dot_f32 as _dot
from repro_torch.stream import state as _st
from repro_torch.stream.state import SketchState

PSI_FOLD_BASE = 0x7E0


@dataclasses.dataclass
class TuckerSketch:
    """Per-mode right sketches + the core sketch (see module docstring)."""
    modes: list                # mode-i SketchState: y (I_i, ranks[i])
    z: torch.Tensor            # core sketch (s_0, ..., s_{N-1})
    key_psis: tuple            # key words per mode
    rows_seen: int
    dims: tuple
    ranks: tuple
    core_dims: tuple

    @property
    def device(self) -> torch.device:
        return self.z.device


def _psi(key, shape, col_offset: int = 0, device=None) -> torch.Tensor:
    """Core-sketch factor block from the counter lattice, f32 (the core
    contractions run at full precision; only the big mode GEMMs are
    mixed-precision)."""
    return _kf.reference_omega(key, shape, dist="gaussian",
                               dtype=torch.float32, col_offset=col_offset,
                               device=device)


def tucker_init(key, dims, ranks, *, core_oversample: int = 1,
                method: proj.ProjectionMethod = "shgemm_fused",
                dist: proj.SketchDist = "gaussian",
                omega_dtype=torch.bfloat16, device=None) -> TuckerSketch:
    """Fresh streaming-Tucker sketch for a tensor of shape ``dims`` slabbed
    along axis 0, for multilinear ranks ``ranks``.  Core-sketch sizes are
    s_i = min(2 ranks[i] + core_oversample, dims[i]): the pinv recovery
    needs s_i > ranks[i]."""
    dev = resolve_device(device)
    dims = tuple(int(d) for d in dims)
    ranks = tuple(int(r) for r in ranks)
    if len(dims) != len(ranks):
        raise ValueError(f"dims {dims} / ranks {ranks} length mismatch")
    if dist == "srht":
        raise ValueError(
            "dist='srht' does not stream through axis-0 slabs: a slab is a "
            "PARTIAL-width column range of every mode-i>=1 unfolding, and "
            "partial tiles have no FWHT shortcut — use 'khatri_rao' for "
            "structured mode sketches, or an unstructured dist")
    core_dims = tuple(min(2 * r + core_oversample, d)
                      for r, d in zip(ranks, dims))
    modes = []
    for i, (d, r) in enumerate(zip(dims, ranks)):
        n_cols = math.prod(dj for j, dj in enumerate(dims) if j != i)
        key_i = _st.fold_in_words(key, i)
        if dist == "khatri_rao":
            # an accumulator only: Y_i is filled by the factor-by-factor
            # contraction, no flat (n_cols, r) Omega exists; the key seeds
            # the mode's KhatriRaoOmega factors
            modes.append(SketchState(
                y=torch.zeros((d, r), dtype=torch.float32, device=dev),
                n_cols=n_cols, key_omega=key_i, method=str(method),
                dist="khatri_rao", omega_dtype=omega_dtype))
        else:
            modes.append(_st.init(key_i, n_cols, r, max_rows=d,
                                  method=method, dist=dist,
                                  omega_dtype=omega_dtype, device=dev))
    key_psis = tuple(_st.fold_in_words(key, PSI_FOLD_BASE + i)
                     for i in range(len(dims)))
    return TuckerSketch(
        modes=modes, z=torch.zeros(core_dims, dtype=torch.float32,
                                   device=dev),
        key_psis=key_psis, rows_seen=0, dims=dims, ranks=ranks,
        core_dims=core_dims)


def _kr_mode_updates(ts: TuckerSketch, slab: torch.Tensor, off: int) -> None:
    """Khatri-Rao mode sketches of one axis-0 slab, contracted factor by
    factor: mode 0 writes the slab's rows of Y_0; mode i > 0 adds an
    (I_i, r_i) partial sum with factor 0's rows taken at the slab offset."""
    b = slab.shape[0]
    for i, st in enumerate(ts.modes):
        kro = _sx.KhatriRaoOmega(key=st.key_omega, dims=ts.dims, mode=i,
                                 p=ts.ranks[i], device=ts.device)
        inc = kro.sketch_slab(slab, axis0_offset=off)
        if i == 0:
            st.y[off:off + b] = inc
        else:
            st.y += inc
        st.rows_seen = max(st.rows_seen, off + b)


def tucker_update(ts: TuckerSketch, slab, row_offset) -> TuckerSketch:
    """Absorb ``slab = A[row_offset : row_offset+b, ...]`` (full trailing
    dims), in place.  Slabs must tile axis 0 exactly; their order is free."""
    slab = on_device(slab, ts.device).to(torch.float32)
    if tuple(slab.shape[1:]) != ts.dims[1:]:
        raise ValueError(f"slab shape {tuple(slab.shape)} does not match "
                         f"dims {ts.dims} along trailing axes")
    b = slab.shape[0]
    off = int(row_offset)
    if ts.modes[0].dist == "khatri_rao":
        _kr_mode_updates(ts, slab, off)
    else:
        _st.update(ts.modes[0], unfold(slab, 0), off)
        for i in range(1, len(ts.dims)):
            stride = math.prod(dj for j, dj in enumerate(ts.dims)
                               if j not in (0, i))
            # unfold() orders the non-mode axes ascending, axis 0 first, so
            # an axis-0 slab is a contiguous column range of every unfolding
            _st.update_cols(ts.modes[i], unfold(slab, i), 0, off * stride)
    # core sketch: Psi_0's column block at the slab offset, then full Psi_i
    contrib = mode_dot(slab, _psi(ts.key_psis[0], (ts.core_dims[0], b),
                                  col_offset=off, device=ts.device), 0)
    for i in range(1, len(ts.dims)):
        contrib = mode_dot(contrib,
                           _psi(ts.key_psis[i], (ts.core_dims[i], ts.dims[i]),
                                device=ts.device), i)
    ts.z += contrib
    ts.rows_seen = max(ts.rows_seen, off + b)
    return ts


def tucker_merge(t1: TuckerSketch, t2: TuckerSketch) -> TuckerSketch:
    """Combine sketches over disjoint slab sets (linearity, cf.
    ``stream.merge``).  Returns a new sketch."""
    for f in ("dims", "ranks", "core_dims"):
        if getattr(t1, f) != getattr(t2, f):
            raise ValueError(f"cannot merge Tucker sketches: {f} differs")
    return dataclasses.replace(
        t1, modes=[_st.merge(a, b) for a, b in zip(t1.modes, t2.modes)],
        z=t1.z + t2.z, rows_seen=max(t1.rows_seen, t2.rows_seen))


def tucker_finalize(ts: TuckerSketch) -> TuckerResult:
    """TuckerResult from the sketches alone (A never revisited):
    Q_i = orth(Y_i); core = Z x_i pinv(Psi_i Q_i)."""
    factors = []
    core = ts.z
    for i, st in enumerate(ts.modes):
        q, _ = torch.linalg.qr(st.y.float())                 # (I_i, r_i)
        factors.append(q)
        m = _dot(_psi(ts.key_psis[i], (ts.core_dims[i], ts.dims[i]),
                      device=ts.device), q)                  # (s_i, r_i)
        core = mode_dot(core, torch.linalg.pinv(m), i)       # s_i -> r_i
    return TuckerResult(core, tuple(factors))


# The finalizer under the reference's other name, "tucker(states)".
tucker = tucker_finalize
