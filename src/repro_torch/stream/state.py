"""Streaming-sketch state: a linear sketch of a matrix that arrives in tiles
(port of ``repro/stream/state.py``).

``SketchState`` carries:

  * ``y``, the right sketch Y = A.Omega, (..., max_rows, p).  Full-width row
    tiles *write* their rows of Y: every Omega element is a pure function of
    (key, global index), so a tile's rows equal the rows of the one-shot
    ``projection.sketch`` of the whole matrix, bit for bit under kernel 2
    (whose bits depend on ``bk``, which depends on ``n_cols`` alone) and
    under SRHT (row-local).
  * ``w``, the optional left sketch W = Psi.A, (l, n_cols), accumulated as
    ``W += Psi[:, rows].A_tile``; Psi's column block at any row offset comes
    from the counter lattice.  The single-pass ``stream.svd`` needs it.
  * the key words of the Omega and Psi streams, the Omega column offset
    ``col_base`` (0, or p_old for a widening extension) and ``rows_seen``,
    the streamed-row high-water mark.

Two kinds of state:
  * key-based, for ``method="shgemm_fused"`` and for ``dist="srht"``: the
    state holds key words and ``col_base``, never Omega.  A row tile runs
    kernel 2 at ``col_offset=col_base``; SRHT runs ``srht_sketch``.
  * Omega-carrying, for the other methods: Omega is drawn once at ``init``
    (``projection.materialize_omega``) and kept.
Either kind may carry a leading batch dimension (``heads=``): the serving
engine keeps one state per (slot, cache leaf) with the heads as a batch,
where the reference vmaps over per-head states; head h gets rows
[h*n_cols, (h+1)*n_cols) of one Omega (a key-based state's kernel-2 call
for head h runs at that row offset).

Algebra: ``update`` (row tiles, write semantics), ``update_cols`` (general
2-D tiles, add semantics), ``merge`` (addition), ``widen`` + ``hstack``
(grow the sketch width over the global lattice; key-based Gaussian/sparse
states only).

Departures from the reference, documented: the reference redraws a legacy
Omega with ``jax.random`` at every update, the port keeps it in the state;
Psi's key and Tucker's per-mode keys come from ``fold_in_words`` (counter
lattice stream 8), not ``jax.random.fold_in``; updates change the state in
place and return it; the kernel-2 plan is the autotuner's at
``ops.fused_plan``'s ``bk``, which depends on k alone, where the reference
pins ``heuristic_blocks``.
``init``'s default method is ``"shgemm"`` (the reference's is
``"shgemm_fused"``; the port's serving engine relies on the default).
``merge_across_hosts`` runs over a ``torch.distributed`` process group (the
reference's over a ``shard_map`` axis name) and adds nothing to an
unpoisoned sketch (the reference adds a zero).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import projection as proj
from repro_torch.core import structured as _sx
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm as _k
from repro_torch.kernels import shgemm_fused as _kf

STREAM_METHODS = ("f32", "lowp_single", "shgemm", "shgemm3", "shgemm_pallas",
                  "shgemm_fused")

# Counter-lattice stream of ``fold_in_words`` (0-1 draw the unstructured
# dists, 4-5 SRHT, 6 the HOSVD mode keys, 7 the serving sketch keys).
FOLD_IN_STREAM = 8
PSI_FOLD = 0x5117


def fold_in_words(key, data: int) -> tuple[int, int]:
    """Key words derived from ``key`` and the integer ``data``: lattice point
    (data, 0 / 1) of the key on stream 8, the port's stand-in for
    ``jax.random.key_data(jax.random.fold_in(key, data))``."""
    k0, k1 = _kf.key_pair(key)
    rows = torch.tensor([[int(data)]], dtype=torch.int64)
    cols = torch.tensor([[0, 1]], dtype=torch.int64)
    words = _kf.counter_bits(k0, k1, rows, cols, FOLD_IN_STREAM)
    return tuple(int(w) for w in words[0].tolist())


@dataclasses.dataclass
class SketchState:
    """Linear sketch accumulator (see the module docstring).  ``omega`` is
    None for key-based states; ``w``/``key_psi`` are None without a left
    sketch."""
    y: torch.Tensor
    n_cols: int
    key_omega: tuple
    omega: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None
    key_psi: Optional[tuple] = None
    rows_seen: int = 0
    method: str = "shgemm"
    dist: str = "gaussian"
    omega_dtype: torch.dtype = torch.bfloat16
    l: int = 0
    col_base: int = 0

    @property
    def max_rows(self) -> int:
        return self.y.shape[-2]

    @property
    def p(self) -> int:
        return self.y.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device

    def widen(self, extra_cols: int) -> "SketchState":
        """Zero extension state over the next ``extra_cols`` columns of the
        same global Omega lattice (starting at ``col_base + p``).  Replay the
        same tiles through ``update`` (kernel 2 hashes only the new lattice
        columns), then ``hstack`` it onto this state: the result equals a
        fresh sketch at the grown width bit for bit.  Only key-based
        ``shgemm_fused`` states without a left sketch or heads can widen."""
        extra = int(extra_cols)
        if extra < 1:
            raise ValueError(f"extra_cols must be >= 1, got {extra_cols}")
        if self.y.ndim != 2:
            raise ValueError("cannot widen a head-batched state")
        if self.dist == "srht":
            raise ValueError(
                "cannot widen an SRHT sketch: every Omega entry carries a "
                "1/sqrt(p) scale tied to the TOTAL sketch width, so a "
                "width-p SRHT shares no columns with a width-(p+e) one — "
                "re-init at the new width and re-sketch (core.rsvd's "
                "adaptive driver does exactly that for SRHT)")
        if self.method != "shgemm_fused":
            raise ValueError(
                f"widen needs method='shgemm_fused' (got {self.method!r}): "
                "a materialized Omega is drawn for its full shape, so "
                "re-init at the new width and re-sketch instead")
        if self.w is not None:
            raise ValueError(
                "cannot widen a left-sketching state: the Psi width l is "
                "sized from p at init — rebuild with init(left=True) at "
                "the final width (the two-pass adaptive driver never "
                "needs W)")
        top = self.col_base + self.p + extra
        if top > self.n_cols:
            raise ValueError(
                f"widening to total sketch width {top} exceeds "
                f"n_cols={self.n_cols}")
        return dataclasses.replace(
            self, y=torch.zeros((self.max_rows, extra), dtype=torch.float32,
                                device=self.device),
            rows_seen=0, col_base=self.col_base + self.p)


def init(key, n_cols: int, p: int, *, max_rows: int, left: bool = False,
         l: int | None = None, method: str = "shgemm",
         dist: proj.SketchDist = "gaussian", omega_dtype=torch.bfloat16,
         heads: int | None = None, device=None) -> SketchState:
    """Fresh sketch state for a matrix with ``n_cols`` columns and up to
    ``max_rows`` streamed rows; ``p`` is the sketch width.

    ``left=True`` also accumulates W = Psi.A (width ``l``, default 2p+1),
    which the single-pass ``stream.svd`` needs; Psi is always on the counter
    lattice.  ``heads`` makes a batch of right sketches, head h on Omega's
    rows [h*n_cols, (h+1)*n_cols) (no left sketch, no structured dist).
    The Omega stream is the one ``projection.sketch(key, ..)`` uses for
    ``method``, so streamed rows match one-shot sketching.
    """
    if p > n_cols:
        raise ValueError(f"sketch width p={p} exceeds n_cols={n_cols}")
    if method not in STREAM_METHODS:
        raise ValueError(f"unknown streaming method {method!r}; use one of "
                         f"{STREAM_METHODS}")
    if dist == "srht" and left:
        raise ValueError(
            "dist='srht' cannot left-sketch: the Psi stream needs "
            "column-block regeneration of an UNSTRUCTURED lattice; use a "
            "sparse/gaussian dist for left-sketching states, or a "
            "right-only SRHT state")
    if dist == "khatri_rao":
        raise ValueError(
            "dist='khatri_rao' is a tensor-mode family — it has no flat "
            "(n_cols, p) Omega for a matrix SketchState; use "
            "stream.tucker.tucker_init(dist='khatri_rao') or "
            "core.structured.KhatriRaoOmega directly")
    if heads is not None and (left or dist in ("srht", "khatri_rao")):
        raise ValueError("heads= batches right sketches only (no left "
                         "sketch, no structured dist)")
    dev = resolve_device(device)
    key_omega = _kf.key_pair(key)
    omega = None
    if carries_omega(method, dist):
        omega = draw_omega(key_omega, n_cols, p, heads=heads, dist=dist,
                           omega_dtype=omega_dtype, device=dev)
    lead = () if heads is None else (heads,)
    l = int(l) if l is not None else 2 * p + 1
    return SketchState(
        y=torch.zeros(lead + (max_rows, p), dtype=torch.float32, device=dev),
        n_cols=int(n_cols), key_omega=key_omega, omega=omega,
        w=(torch.zeros((l, n_cols), dtype=torch.float32, device=dev)
           if left else None),
        key_psi=fold_in_words(key_omega, PSI_FOLD) if left else None,
        method=str(method), dist=str(dist), omega_dtype=omega_dtype, l=l)


def carries_omega(method: str, dist: str) -> bool:
    """Whether a state keeps its Omega (the non-fused methods) or only key
    words (kernel 2 and SRHT, and the Khatri-Rao mode accumulators of
    ``stream.tucker``)."""
    return not (method == "shgemm_fused" or dist in ("srht", "khatri_rao"))


def draw_omega(key_omega, n_cols: int, p: int, *, heads: int | None,
               dist: str, omega_dtype, device) -> torch.Tensor:
    """The Omega an Omega-carrying state keeps: drawn at ``init`` and drawn
    again from the key words when a checkpointed state is restored
    (``stream.resilience.state_from_payload``), bit for bit."""
    omega = proj.materialize_omega(key_omega, (n_cols * (heads or 1), p),
                                   dist=dist, dtype=omega_dtype, device=device)
    return omega if heads is None else omega.reshape(heads, n_cols, p)


def _psi_s(state: SketchState) -> float | None:
    """Psi's sparse-dist parameter from the global row count, not a tile's
    height (one-shot/streamed agreement)."""
    if state.dist == "very_sparse":
        return _kf._resolve_s("very_sparse", None, state.max_rows)
    return None


def _omega_s(state: SketchState) -> float | None:
    """Omega's very-sparse parameter from the global column count, so a
    partial-width tile draws the one-shot distribution."""
    if state.dist == "very_sparse":
        return _kf._resolve_s("very_sparse", None, state.n_cols)
    return None


def fused_at_row_offset(a: torch.Tensor, key, n: int, row_offset: int,
                        **kw) -> torch.Tensor:
    """``ops.shgemm_fused(a, key, n, row_offset=row_offset, **kw)`` for any
    ``row_offset``: kernel 2 takes row offsets on its ``bk`` grid, so the
    offset is rounded down to the 32-row stage (A gains as many leading zero
    columns, whose products are exact zeros) and ``bk`` is the largest
    divisor of the planner's that divides the rounded offset.  Row tiles of any height
    (a ragged 320-row tiling, a short last tile) reach kernel 2 this way."""
    pad = row_offset % _k.STAGE_K
    base = row_offset - pad
    if pad:
        a = F.pad(a, (pad, 0))
    m, k = a.shape
    bm, bn, bk, _ = ops.fused_plan(m, n, k)
    return ops.shgemm_fused(a, key, n, blocks=(bm, bn, math.gcd(bk, base)),
                            row_offset=base,
                            device=a.device, **kw)


def _sketch_rows(state: SketchState, a_block: torch.Tensor) -> torch.Tensor:
    """a_block (..., b, n_cols) -> its rows of Y = A.Omega."""
    if state.dist == "srht":
        return _sx.srht_sketch(state.key_omega, a_block, state.p,
                               device=state.device)
    if state.method == "shgemm_fused":
        kw = dict(dist=state.dist, omega_dtype=state.omega_dtype,
                  s=_omega_s(state), col_offset=state.col_base)
        if a_block.ndim == 3:            # heads: head h at Omega row h*n_cols
            return torch.stack([
                fused_at_row_offset(a, state.key_omega, state.p,
                                    h * state.n_cols, **kw)
                for h, a in enumerate(a_block)])
        return ops.shgemm_fused(a_block, state.key_omega, state.p,
                                device=state.device, **kw)
    return proj.project(a_block, state.omega, method=state.method,
                        device=state.device)


def _psi_block_t(state: SketchState, rows: int, row_offset: int) -> torch.Tensor:
    """Psi^T[row_offset : row_offset+rows, :l] from the counter lattice."""
    return _kf.reference_omega(state.key_psi, (rows, state.l), dist=state.dist,
                               s=_psi_s(state), dtype=state.omega_dtype,
                               row_offset=row_offset, device=state.device)


def _left_update(state: SketchState, a_block: torch.Tensor,
                 row_offset: int) -> torch.Tensor:
    """W increment Psi[:, rows].A_tile, as (A_tile^T . Psi^T_rows)^T."""
    at = a_block.T                                   # (cols, b)
    if state.method == "shgemm_fused":
        inc = fused_at_row_offset(at, state.key_psi, state.l, row_offset,
                                  dist=state.dist,
                                  omega_dtype=state.omega_dtype,
                                  s=_psi_s(state))
    else:
        inc = proj.project(at, _psi_block_t(state, a_block.shape[0],
                                            row_offset),
                           method=state.method, device=state.device)
    return inc.T                                     # (l, cols)


def _concrete_int(x) -> int:
    """int(x) for a Python or 0-d tensor offset (the port runs eagerly, so
    every offset is concrete)."""
    return int(x)


def _check_offset(off, extent: int, limit: int, what: str, name: str) -> None:
    """Bounds check of an offset: an overrun fails rather than writing past
    the state."""
    off = _concrete_int(off)
    if off < 0:
        raise ValueError(f"{name}={off} must be >= 0")
    if off + extent > limit:
        raise ValueError(f"{name}={off} + tile {what} {extent} overruns "
                         f"{limit} — the update would overwrite other rows")


def update(state: SketchState, a_block, row_offset) -> SketchState:
    """Absorb the full-width row tile ``a_block`` (..., b, n_cols) =
    A[row_offset:row_offset+b]: its rows of Y are written and W accumulates
    Psi[:, rows].tile, in place.  Tiles must not overlap."""
    a_block = on_device(a_block, state.device).to(torch.float32)
    if a_block.ndim != state.y.ndim:
        raise ValueError(f"update takes a row tile of {state.y.ndim} dims, "
                         f"got shape {tuple(a_block.shape)}; stream tensors "
                         f"through stream.tucker or unfold them first")
    b, n = a_block.shape[-2:]
    if n != state.n_cols:
        raise ValueError(f"row tile has {n} columns, state expects "
                         f"{state.n_cols}; use update_cols for partial-width "
                         f"tiles")
    _check_offset(row_offset, b, state.max_rows, "height", "row_offset")
    off = _concrete_int(row_offset)
    state.y[..., off:off + b, :] = _sketch_rows(state, a_block)
    if state.w is not None:
        state.w += _left_update(state, a_block, off)
    state.rows_seen = max(state.rows_seen, off + b)
    return state


def update_cols(state: SketchState, a_block, row_offset,
                col_offset) -> SketchState:
    """Absorb a general 2-D tile ``A[r0:r0+br, c0:c0+bc]`` with add
    semantics, in place:

      Y[r0:r0+br] += tile . Omega[c0:c0+bc]      (kernel 2 at row offset c0)
      W[:, c0:c0+bc] += Psi[:, r0:r0+br] . tile  (kernel 2 at row offset r0)

    Deterministic given the tile order; tiles must cover A exactly once.
    """
    a_block = on_device(a_block, state.device).to(torch.float32)
    if a_block.ndim != 2 or state.y.ndim != 2:
        raise ValueError(f"update_cols takes a 2-D tile into an unbatched "
                         f"state, got shape {tuple(a_block.shape)}")
    br, bc = a_block.shape
    if bc > state.n_cols:
        raise ValueError(f"tile has {bc} columns > n_cols={state.n_cols}")
    _check_offset(row_offset, br, state.max_rows, "height", "row_offset")
    _check_offset(col_offset, bc, state.n_cols, "width", "col_offset")
    r0, c0 = _concrete_int(row_offset), _concrete_int(col_offset)
    if state.dist == "srht":
        # a partial-width tile covers only some Hadamard inputs: no FWHT
        # shortcut, so the (bc, p) Omega row block is applied densely
        om_blk = _sx.srht_omega(state.key_omega, (bc, state.p),
                                n_total=state.n_cols, row_offset=c0,
                                device=state.device)
        y_inc = proj.project(a_block, om_blk, method="f32",
                             device=state.device)
    elif state.method == "shgemm_fused":
        y_inc = fused_at_row_offset(a_block, state.key_omega, state.p, c0,
                                    dist=state.dist,
                                    omega_dtype=state.omega_dtype,
                                    s=_omega_s(state),
                                    col_offset=state.col_base)
    else:
        y_inc = proj.project(a_block, state.omega[c0:c0 + bc],
                             method=state.method, device=state.device)
    state.y[r0:r0 + br] += y_inc
    if state.w is not None:
        state.w[:, c0:c0 + bc] += _left_update(state, a_block, r0)
    state.rows_seen = max(state.rows_seen, r0 + br)
    return state


def _meta_mismatch(s1: SketchState, s2: SketchState) -> str | None:
    """Name of the first config field that differs, or None."""
    for f in ("n_cols", "p", "l", "method", "dist", "omega_dtype",
              "col_base", "max_rows"):
        if getattr(s1, f) != getattr(s2, f):
            return f
    return None


def merge(s1: SketchState, s2: SketchState) -> SketchState:
    """Combine two states built from disjoint tile sets of the same matrix:
    sketches are linear in A, so merge is addition (commutative bit for bit,
    associative to f32 rounding).  Returns a new state."""
    bad = _meta_mismatch(s1, s2)
    if bad is not None:
        raise ValueError(f"cannot merge sketch states: {bad} differs "
                         f"({getattr(s1, bad)!r} vs {getattr(s2, bad)!r})")
    if s1.key_omega != s2.key_omega:
        raise ValueError("cannot merge sketch states drawn from different "
                         "Omega keys — the sketches live in different "
                         "random subspaces")
    if (s1.w is None) != (s2.w is None):
        raise ValueError("cannot merge a left-sketching state with a "
                         "right-only one")
    w = None
    if s1.w is not None:
        if s1.key_psi != s2.key_psi:
            raise ValueError("cannot merge sketch states drawn from "
                             "different Psi keys")
        w = s1.w + s2.w
    return dataclasses.replace(s1, y=s1.y + s2.y, w=w,
                               rows_seen=max(s1.rows_seen, s2.rows_seen))


def hstack(base: SketchState, ext: SketchState) -> SketchState:
    """Concatenate a widening extension (``base.widen(extra)`` replayed over
    the same tiles) onto its base: the result's Y is column for column the
    fresh sketch at the grown width."""
    for f in ("n_cols", "l", "method", "dist", "omega_dtype", "max_rows"):
        if getattr(base, f) != getattr(ext, f):
            raise ValueError(
                f"cannot hstack sketch states: {f} differs "
                f"({getattr(base, f)!r} vs {getattr(ext, f)!r})")
    if ext.col_base != base.col_base + base.p:
        raise ValueError(
            f"extension's Omega columns start at lattice offset "
            f"{ext.col_base}, but the base state ends at "
            f"{base.col_base + base.p} — hstack needs a contiguous "
            f"extension (build it with base.widen(extra_cols))")
    if base.key_omega != ext.key_omega:
        raise ValueError("cannot hstack sketch states drawn from different "
                         "Omega keys — the columns live on different "
                         "random lattices")
    if base.w is not None or ext.w is not None:
        raise ValueError("cannot hstack left-sketching states (widen() "
                         "refuses to create them)")
    if base.rows_seen != ext.rows_seen:
        raise ValueError(
            f"extension's streamed-row high-water mark is {ext.rows_seen} "
            f"but the base state's is {base.rows_seen} — the widen replay "
            f"must re-stream the tiles the base saw, or the new columns "
            f"describe a different matrix")
    return dataclasses.replace(base, y=torch.cat([base.y, ext.y], dim=1))


def merge_across_hosts(state: SketchState, group=None, *,
                       check_keys: bool = True) -> SketchState:
    """Collective ``merge``: combine the per-host states of a data-parallel
    group into the global sketch, called on every rank of ``group`` (a
    ``torch.distributed`` process group, such as a bound
    ``HostMesh.group("data")``; ``None`` is the whole world).

    Linearity makes this an ``all_reduce`` SUM of Y (and W): for disjoint
    row coverage it equals single-host accumulation bit for bit, because
    every other host adds exact zeros to a row.  ``rows_seen`` is the MAX
    over the group.  Static configuration (n_cols, p, l, method, ...) is
    structural under SPMD: every rank runs the same program.  The keys are
    data and can differ across hosts; with ``check_keys`` the result is
    poisoned to NaN when any rank's key words differ (MAX against MIN of
    ``key_omega`` / ``key_psi``): a loud failure instead of a sum of
    sketches from different random subspaces.  Returns a new state."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("merge_across_hosts runs on every rank of a "
                           "torch.distributed world: call "
                           "init_process_group first (or stream.merge on "
                           "one process)")
    y = state.y.clone()
    dist.all_reduce(y, group=group)
    w = None
    if state.w is not None:
        w = state.w.clone()
        dist.all_reduce(w, group=group)
    rows = torch.tensor([state.rows_seen], dtype=torch.int64,
                        device=state.device)
    dist.all_reduce(rows, op=dist.ReduceOp.MAX, group=group)
    if check_keys:
        words = torch.tensor([*state.key_omega, *(state.key_psi or ())],
                             dtype=torch.int64, device=state.device)
        hi, lo = words.clone(), words.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        if not torch.equal(hi, lo):
            y += float("nan")
            if w is not None:
                w += float("nan")
    return dataclasses.replace(state, y=y, w=w, rows_seen=int(rows.item()))
