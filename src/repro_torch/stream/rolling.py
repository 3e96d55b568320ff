"""Rolling (sliding-window) sketch: a ``SketchState`` variant for overwritten
rows (port of ``repro/stream/rolling.py``).

Append-only streams fit the linear ``SketchState`` because every row of the
right sketch Y = A.Omega depends on exactly one row of A: Omega is a pure
function of (key, column index), so row i of Y is ``A[i] . Omega`` whatever
the tile boundaries.  Sliding-window consumers (the ring-buffer KV caches of
``models/cache.py``'s local layers) overwrite old rows, and a linear sketch
would keep their contribution forever.

The same per-row structure is the fix: keep a **ring of per-row sketches**.
Writing the row at absolute position ``a`` lands its sketch in ring slot
``a % capacity`` — the arriving row evicts the one that just left the window,
with no subtraction and no stored history.  Finalizing rotates the ring into
window order and masks slots the window has not reached yet, producing a
plain ``SketchState`` over the current window:

    rolling_finalize(state)  ==  init(key, ...); update(window_rows, 0)

bit for bit (``decay == 1``) under kernel 2 and the other methods alike,
because each Y row is a pure function of (its row data, key) and kernel 2's
bits depend on ``n_cols`` alone.  Everything downstream
(``stream.range_basis``, ``serve.kv_compress`` factorization) consumes the
finalized state unchanged.

Decay: with ``decay = g < 1`` the finalized sketch is the fresh sketch of
``diag(g^age) . window`` (the newest row has weight 1), applied at finalize
time only, so the ring always stores unweighted per-row sketches.

Left sketches are not supported (evicting a row would need the evicted row
data), so the single-pass ``stream.svd`` refuses a finalized rolling state.

Departures from the reference: the state is updated in place and returned
(as ``stream.update`` does); ``heads=`` batches states over a leading head
axis, where the reference vmaps per-head states — the serving
engine's rolling KV sketches (``serve.kv_compress.kv_rolling_*``) use it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import projection as proj
from repro_torch.device import on_device
from repro_torch.stream.state import (SketchState, _concrete_int,
                                      _sketch_rows, init)


@dataclasses.dataclass
class RollingSketchState:
    """Ring of per-row sketches over the trailing ``window`` rows.

    ``base`` is a plain ``SketchState`` whose ``y`` holds the ring (capacity
    = ``base.max_rows`` slots; absolute row ``a`` lives in slot
    ``a % capacity``) and whose ``rows_seen`` is the absolute high-water
    mark (total rows ever streamed, not the live count).  ``window`` <=
    capacity is the number of trailing rows a finalize exposes."""
    base: SketchState
    window: int = 0
    decay: float = 1.0

    @property
    def capacity(self) -> int:
        return self.base.max_rows

    @property
    def rows_seen(self) -> int:
        return self.base.rows_seen


def rolling_init(key, n_cols: int, p: int, *, window: int,
                 max_rows: int | None = None, method: str = "shgemm_fused",
                 dist: proj.SketchDist = "gaussian",
                 omega_dtype=torch.bfloat16, decay: float = 1.0,
                 heads: int | None = None, device=None) -> RollingSketchState:
    """Fresh rolling sketch for a width-``window`` sliding view of a stream
    of ``n_cols``-column rows.

    ``max_rows`` is the ring capacity (default ``window``); a smaller ring
    than the window would evict rows still inside it, so that raises.  The
    Omega stream is the one ``stream.init`` draws for ``key``, which is what
    makes ``rolling_finalize`` equal a fresh window sketch.  ``heads``
    batches states over a leading axis (``stream.init``).
    """
    capacity = int(window) if max_rows is None else int(max_rows)
    if window <= 0:
        raise ValueError(f"window={window} must be positive")
    if window > capacity:
        raise ValueError(
            f"rolling-sketch window {window} exceeds ring capacity "
            f"max_rows={capacity} — rows would be evicted while still "
            f"inside the window (no silent clamping); grow max_rows or "
            f"shrink the window")
    if not (0.0 < decay <= 1.0):
        raise ValueError(f"decay={decay} must be in (0, 1]")
    base = init(key, n_cols, p, max_rows=capacity, method=method, dist=dist,
                omega_dtype=omega_dtype, heads=heads, device=device)
    return RollingSketchState(base=base, window=int(window),
                              decay=float(decay))


def rolling_update(state: RollingSketchState, a_block,
                   pos=None) -> RollingSketchState:
    """Absorb ``a_block`` = rows [pos, pos+b) of the stream (absolute
    positions; ``pos`` defaults to the high-water mark, i.e. append), in
    place.  A head-batched state takes (heads, b, n_cols) tiles.

    Each row's sketch overwrites ring slot ``row % capacity``.  Appends must
    be monotone: a ``pos`` behind rows already streamed raises (rewriting
    history would corrupt the eviction order).  Gaps are allowed (the
    engine's uniform slot clock can skip positions) and gap rows count as
    zero: the ring slots a gap jumps over are cleared, so a later finalize
    never exposes the lap-old sketches that lived there.  Tiles taller than
    the ring would wrap onto themselves and are refused."""
    base = state.base
    a_block = on_device(a_block, base.device).to(torch.float32)
    if a_block.ndim != base.y.ndim:
        raise ValueError(
            f"rolling_update takes a 2-D row tile"
            f"{' per head, (heads, b, n_cols)' if base.y.ndim == 3 else ''}, "
            f"got shape {tuple(a_block.shape)}")
    b, n = a_block.shape[-2:]
    if n != base.n_cols:
        raise ValueError(f"row tile has {n} columns, state expects "
                         f"{base.n_cols}")
    if b > state.capacity:
        raise ValueError(
            f"tile of {b} rows exceeds ring capacity {state.capacity} — "
            f"rows would wrap onto themselves; split the tile")
    off = base.rows_seen if pos is None else _concrete_int(pos)
    if off < 0:
        raise ValueError(f"pos={off} must be >= 0")
    if off < base.rows_seen:
        raise ValueError(
            f"pos={off} is behind rows already streamed "
            f"(rows_seen={base.rows_seen}) — rolling appends must be "
            f"monotone")
    cap = state.capacity
    dev = base.device
    gap = min(off - base.rows_seen, cap)
    if gap > 0:
        # positions [rows_seen, pos) were never streamed: their slots still
        # hold lap-old sketches a finalize inside the gap's window would
        # expose as live rows
        idx = (base.rows_seen + torch.arange(gap, device=dev)) % cap
        base.y[..., idx, :] = 0.0
    idx = (off + torch.arange(b, device=dev)) % cap
    base.y[..., idx, :] = _sketch_rows(base, a_block)
    base.rows_seen = max(base.rows_seen, off + b)
    return state


def rolling_finalize(state: RollingSketchState) -> SketchState:
    """Rotate the ring into window order -> a plain ``SketchState`` over the
    current window (max_rows == window, rows_seen == live row count).

    Equal to ``init(key, ...); update(window_rows, 0)`` for ``decay == 1``.
    With ``decay = g < 1`` row ``j`` is scaled by ``g**(live-1-j)`` (newest
    row unweighted): the fresh sketch of the age-weighted window.  The ring
    itself is left as it was."""
    base = state.base
    total = base.rows_seen                                     # absolute
    live = min(total, state.window)
    start = total - live                                       # row 0's pos
    dev = base.device
    j = torch.arange(state.window, device=dev)
    y = base.y[..., (start + j) % state.capacity, :]           # (.., window, p)
    seen = j < live
    y[..., ~seen, :] = 0.0
    if state.decay != 1.0:
        age = (live - 1 - j).to(torch.float32)                 # newest -> 0
        g = torch.tensor(state.decay, dtype=torch.float32, device=dev)
        weight = torch.where(seen, torch.pow(g, age), torch.zeros_like(age))
        y = y * weight[:, None]
    return dataclasses.replace(base, y=y, rows_seen=live)
