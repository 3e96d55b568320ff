"""Streaming-sketch state: the right sketch Y = A.Omega of a matrix that
arrives in full-width row tiles (port of the right-sketch part of
``repro/stream/state.py``).

Row tiles *write* their rows of Y, so streamed tiles give the rows of the
one-shot ``projection.sketch`` of the concatenated matrix.  A state may
carry leading batch dimensions (``heads=``): the serving engine keeps one
state per (slot, cache leaf) with the heads as a batch, where the reference
vmaps over per-head states.

Deviations from the reference, both documented:
  * Omega is drawn once at ``init`` from the counter lattice
    (``projection.materialize_omega``) and kept in the state; the reference
    keeps the key and redraws Omega with ``jax.random`` at every update.  A
    batched state draws one (heads * n_cols, p) Omega and gives head h its
    h-th row block.
  * Updates write Y in place and return the same state.
Only the plain GEMM methods stream here; ``left=True`` (the Psi sketch),
``update_cols``, ``merge``, ``widen``, ``hstack`` and the fused-kernel
method wait for ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import projection as proj

STREAM_METHODS = ("f32", "lowp_single", "shgemm", "shgemm3")


@dataclasses.dataclass
class SketchState:
    """Right-sketch accumulator: ``y`` (..., max_rows, p) f32, ``omega``
    (..., n_cols, p) in the Omega dtype, ``rows_seen`` the streamed-row
    high-water mark (one clock for every batch entry)."""
    y: torch.Tensor
    omega: torch.Tensor
    rows_seen: int = 0
    method: str = "shgemm"

    @property
    def max_rows(self) -> int:
        return self.y.shape[-2]

    @property
    def n_cols(self) -> int:
        return self.omega.shape[-2]

    @property
    def p(self) -> int:
        return self.y.shape[-1]


def init(key, n_cols: int, p: int, *, max_rows: int, method: str = "shgemm",
         dist: proj.SketchDist = "gaussian", omega_dtype=torch.bfloat16,
         heads: int | None = None, device=None) -> SketchState:
    """Fresh sketch state for a matrix with ``n_cols`` columns and up to
    ``max_rows`` streamed rows (a batch of ``heads`` such states if given).
    ``p`` is the sketch width (rank + oversample at the consumer level)."""
    if p > n_cols:
        raise ValueError(f"sketch width p={p} exceeds n_cols={n_cols}")
    if method not in STREAM_METHODS:
        raise NotImplementedError(
            f"streaming method {method!r} is not ported yet (ROADMAP Queue 1 "
            f"item 12); use one of {STREAM_METHODS}")
    n = n_cols * (heads or 1)
    omega = proj.materialize_omega(key, (n, p), dist=dist, dtype=omega_dtype,
                                   device=device)
    lead = () if heads is None else (heads,)
    return SketchState(
        y=torch.zeros(lead + (max_rows, p), dtype=torch.float32,
                      device=omega.device),
        omega=omega.reshape(lead + (n_cols, p)), method=method)


def _concrete_int(x) -> int:
    """int(x) for a Python or 0-d tensor offset (the port runs eagerly, so
    every offset is concrete)."""
    return int(x)


def _check_offset(off, extent: int, limit: int, what: str, name: str) -> None:
    """Bounds check of a row offset: an overrun fails rather than writing
    past the state."""
    off = _concrete_int(off)
    if off < 0:
        raise ValueError(f"{name}={off} must be >= 0")
    if off + extent > limit:
        raise ValueError(f"{name}={off} + tile {what} {extent} overruns "
                         f"{limit} — the update would overwrite other rows")


def update(state: SketchState, a_block: torch.Tensor, row_offset) -> SketchState:
    """Absorb the full-width row tile ``a_block`` (..., b, n_cols) =
    A[row_offset:row_offset+b]: its rows of Y are written (in place)."""
    a_block = a_block.float()
    if a_block.ndim != state.y.ndim:
        raise ValueError(f"update takes a row tile of {state.y.ndim} dims "
                         f"(batch + 2), got shape {tuple(a_block.shape)}")
    b, n = a_block.shape[-2:]
    if n != state.n_cols:
        raise ValueError(f"row tile has {n} columns, state expects "
                         f"{state.n_cols}")
    _check_offset(row_offset, b, state.max_rows, "height", "row_offset")
    off = _concrete_int(row_offset)
    state.y[..., off:off + b, :] = proj.project(a_block, state.omega,
                                                method=state.method,
                                                device=a_block.device)
    state.rows_seen = max(state.rows_seen, off + b)
    return state
