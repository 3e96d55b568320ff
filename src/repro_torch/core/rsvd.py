"""Randomized SVD (paper Algorithm 1) with mixed-precision random projection
(port of ``repro/core/rsvd.py``).

The random projection (line 1, the O(mnp) term) is the paper's target and
runs through ``projection.sketch``; QR (line 2), B = Q^T A (line 3), the
small SVD (line 4) and the back-projection (line 5) run in f32 through
``torch.linalg`` and ``torch.matmul`` (TF32 off), as the reference leaves
them to XLA.  ``rsvd_streamed`` runs the same algorithm over row tiles of an
out-of-core matrix (``repro_torch.stream``), checkpointed and resumable
through ``stream.resilience``.  The test-matrix builders draw from an
explicit ``torch.Generator`` on the device where the matrix is wanted.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import torch

from repro_torch.core import projection as proj
from repro_torch.core import structured as _sx
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels.ref import dot_f32 as _dot


class SVDResult(NamedTuple):
    u: torch.Tensor      # (m, rank)
    s: torch.Tensor      # (rank,)
    vt: torch.Tensor     # (rank, n)


class AdaptiveInfo(NamedTuple):
    """Diagnostics of one adaptive ``rsvd_streamed(tol=...)`` run.
    ``est_history`` holds the relative posterior error estimate after each
    B pass (one entry per evaluated width); ``bound_history`` the matching
    relative Halko Eq. (4) bound, None where the width leaves oversample < 2
    and at every width for non-Gaussian families (``bound_reason`` says
    why).  ``grown_sketch_bytes`` is what the widen passes wrote to Y,
    ``full_resketch_bytes`` what re-sketching from scratch at each grown
    width would have written."""
    final_p: int
    widen_passes: int
    converged: bool
    est_history: tuple
    bound_history: tuple
    grown_cols: int
    grown_sketch_bytes: int
    full_resketch_bytes: int
    bound_reason: str | None = None


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


def _check_checkpoint_args(checkpoint_dir, checkpoint_every_tiles, resume,
                           return_report) -> None:
    """The reference's checks of the checkpoint arguments without a
    checkpoint directory."""
    if checkpoint_dir is None:
        if checkpoint_every_tiles is not None:
            raise ValueError("checkpoint_every_tiles needs checkpoint_dir=")
        if resume:
            raise ValueError("resume=True needs checkpoint_dir= (there is "
                             "nowhere to resume from)")
        if return_report:
            raise ValueError("return_report=True needs checkpoint_dir= "
                             "(the report measures the checkpointed job)")


def rsvd_streamed(key, a_blocks, rank: int, *, n_rows: int | None = None,
                  n_cols: int | None = None, oversample: int = 10,
                  passes: int = 2,
                  method: proj.ProjectionMethod = "shgemm_fused",
                  dist: proj.SketchDist = "gaussian",
                  omega_dtype=torch.bfloat16, tile_callback=None,
                  prefetch_depth: int | None = 1, tol: float | None = None,
                  max_oversample: int | None = None,
                  return_info: bool = False, checkpoint_dir=None,
                  checkpoint_every_tiles: int | None = None,
                  resume: bool = False, return_report: bool = False,
                  device=None):
    """Randomized SVD of an out-of-core matrix streamed as row tiles.

    ``a_blocks`` is anything ``stream.as_tile_source`` accepts (a
    ``TileSource``, an array, an ``.npy`` path or a directory of shards, a
    sequence of row tiles, a zero-arg callable returning a fresh tile
    iterator, or for ``passes=1`` a bare one-shot generator).
    ``n_rows``/``n_cols`` may be omitted when the source knows its shape.
    Tiles are prefetched to ``device`` (``prefetch_depth=None`` disables);
    at most ``prefetch_depth + 1`` tiles of A live beside O((m+n).p) of
    state.  With ``method="shgemm_fused"`` Omega never exists in device
    memory and each tile's sketch rows equal the one-shot sketch's bit for
    bit.

    ``passes``: 1 finalizes from the (Y, W) sketches alone (Tropp et al.
    2017); 2 sketches, orthonormalizes and replays once for B = Q^T A (as
    ``rsvd(power_iters=0)`` up to f32 summation order); >= 3 runs streamed
    power iteration (``passes = 2 + 2q`` is ``rsvd(power_iters=q)``'s
    iteration; odd counts finalize from the column basis at no extra pass).

    ``tile_callback(i, n_seen_rows)`` runs after each tile of the sketch
    pass.

    Adaptive mode (``tol=...``, ``passes=2`` only, replayable source): after
    each B pass the rank-``rank`` truncation error is known exactly
    (||A||^2 - sum_{i<=r} sigma_i(B)^2, relative to ||A||_F); while it
    exceeds ``tol`` the sketch width doubles its oversampling, capped at
    ``rank + max_oversample`` and min(m, n).  Kernel 2 widens incrementally
    (``SketchState.widen``, only the new columns); other methods and SRHT
    re-sketch at the new width.  ``return_info=True`` also returns an
    :class:`AdaptiveInfo`.

    Fault tolerance (``checkpoint_dir=...``): the sketch state and a tile
    cursor are checkpointed every ``checkpoint_every_tiles`` tiles (default
    16; atomic, written by a background thread), so a job restarted with
    ``resume=True`` goes on from its last checkpoint.  The cursor is a tile
    boundary and the replay keeps the tile order, so the resumed result
    equals the uninterrupted run's bit for bit, with at most
    ``checkpoint_every_tiles`` tiles recomputed in the sketch and B passes
    (power passes, ``passes >= 3``, checkpoint at pass boundaries: one pass
    recomputed at worst).  ``resume=True`` on an empty directory is a fresh
    start; ``resume=False`` clears the directory's earlier job; a checkpoint
    of another key, rank, method or shape fails loudly (fingerprint
    mismatch).  Needs a replayable source and refuses ``tol=``.  A fault
    that raises reaches the caller after the pending checkpoint writes are
    on disk.  ``return_report=True`` also returns a
    ``stream.resilience.ResilienceReport``.
    """
    from repro_torch import stream  # stream imports this module's results
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    if tol is not None:
        tol = float(tol)
        if tol <= 0.0:
            raise ValueError(f"tol must be > 0, got {tol}")
        if passes != 2:
            raise ValueError(
                f"adaptive mode (tol=) owns the pass schedule — it runs "
                f"2 + 2*(widen rounds) passes — so passes must stay at its "
                f"default 2, got passes={passes}")
    if max_oversample is not None:
        if tol is None:
            raise ValueError("max_oversample only applies to adaptive "
                             "(tol=...) runs")
        max_oversample = int(max_oversample)
        if max_oversample < 0:
            raise ValueError(f"max_oversample must be >= 0, got "
                             f"{max_oversample}")
    if return_info and tol is None:
        raise ValueError("return_info=True only applies to adaptive "
                         "(tol=...) runs")
    _check_checkpoint_args(checkpoint_dir, checkpoint_every_tiles, resume,
                           return_report)
    if checkpoint_dir is not None and tol is not None:
        raise ValueError(
            "checkpoint_dir is incompatible with adaptive mode (tol=): "
            "the widen schedule is data-dependent, so a resumed run "
            "could not prove it replays the identical pass sequence")
    dev = resolve_device(device)
    shape = ((int(n_rows), int(n_cols))
             if n_rows is not None and n_cols is not None else None)
    try:
        src = stream.as_tile_source(a_blocks, shape=shape)
    except ValueError as e:
        if shape is None and "shape" in str(e):
            raise ValueError(
                "this tile stream cannot be inspected for its shape: pass "
                "BOTH n_rows= and n_cols= (or stream from a "
                "TileSource/array/.npy path, which knows its shape)") from e
        raise
    if n_rows is not None and int(n_rows) != src.n_rows:
        raise ValueError(f"n_rows={n_rows} but the tile source has "
                         f"{src.n_rows} rows")
    if n_cols is not None and int(n_cols) != src.n_cols:
        raise ValueError(f"n_cols={n_cols} but the tile source has "
                         f"{src.n_cols} columns")
    n_rows, n_cols = src.n_rows, src.n_cols
    if passes >= 2 and not src.replayable:
        # fail before streaming, not hours into an out-of-core run
        raise ValueError(
            f"passes={passes} must replay the tile stream: pass a "
            "replayable TileSource (array / memmap / directory-of-npy / "
            "zero-arg factory) or a sequence of tiles (or use passes=1 "
            "for the strict single-pass finalizer)")

    ck = None   # bound below; tiles() reads it through the closure

    def tiles(start_tile=0, start_row=0):
        # From a resume cursor the tiles are the exact suffix of the full
        # tiling (same boundaries, same order), so every f32 sum downstream
        # sees an uninterrupted run's operands.  A tile is timed from its
        # request to the next one's: the consumer's absorption of it.
        t_last = time.perf_counter()
        for i, (off, blk) in enumerate(stream.offset_tiles(
                src, prefetch_depth=prefetch_depth, device=dev,
                start_row=start_row), start=start_tile):
            yield i, off, on_device(blk, dev).to(torch.float32)
            if ck is not None:
                now = time.perf_counter()
                ck.note_tile(now - t_last)
                t_last = now

    _check_rank(rank, n_rows, n_cols)
    minmn = min(n_rows, n_cols)
    p_cap = minmn
    if max_oversample is not None:
        p_cap = min(p_cap, rank + max_oversample)
    p_hat = min(rank + oversample, p_cap if tol is not None else minmn)

    if checkpoint_dir is not None:
        from repro_torch.stream import resilience as resil
        if not src.replayable:
            raise ValueError(
                "checkpoint_dir needs a replayable tile source: resuming "
                "replays the tile suffix after the checkpointed cursor, "
                "which a one-shot generator cannot provide")
        fingerprint = {
            "job": "rsvd_streamed",
            "key": resil.key_fingerprint(key),
            "rank": int(rank), "p_hat": int(p_hat), "passes": int(passes),
            "method": str(method), "dist": str(dist),
            "omega_dtype": resil.dtype_name(omega_dtype),
            "n_rows": int(n_rows), "n_cols": int(n_cols),
            **resil.omega_fingerprint(method),
        }
        ck = resil.SketchJobCheckpointer(
            checkpoint_dir,
            every_tiles=(16 if checkpoint_every_tiles is None
                         else checkpoint_every_tiles),
            fingerprint=fingerprint, resume=resume)

    def done(res):
        if ck is None:
            return res
        report = ck.finish(
            tiles_total=(resil._count_tiles(src) or 0) * passes)
        return (res, report) if return_report else res

    with ck if ck is not None else contextlib.nullcontext():
        restored = ck.restore() if ck is not None else None
        start_tile = start_row = 0
        b_resume = power_resume = None
        if restored is None:
            state = stream.init(key, n_cols, p_hat, max_rows=n_rows,
                                left=(passes == 1), method=method, dist=dist,
                                omega_dtype=omega_dtype, device=dev)
        elif restored.phase in ("sketch", "b"):
            state = resil.state_from_payload(restored.arrays, restored.meta,
                                             device=dev)
            if restored.phase == "sketch":
                start_tile, start_row = restored.tiles_done, restored.rows_done
            else:
                b_resume = (resil.array_to_tensor(restored.arrays["b"], dev),
                            restored.tiles_done, restored.rows_done)
        elif restored.phase == "power":
            power_resume = restored
        else:
            raise RuntimeError(f"checkpoint under {checkpoint_dir} is in "
                               f"unknown phase {restored.phase!r}")

        fro2 = torch.zeros((), dtype=torch.float32, device=dev)  # ||A||_F^2
        if b_resume is None and power_resume is None:
            tiles_done, rows_done = start_tile, start_row
            for i, off, blk in tiles(start_tile, start_row):
                stream.update(state, blk, off)
                if tol is not None:
                    fro2 = fro2 + torch.sum(torch.square(blk))
                if tile_callback is not None:
                    tile_callback(i, off + blk.shape[0])
                tiles_done, rows_done = i + 1, off + int(blk.shape[0])
                if ck is not None:
                    ck.tick(phase="sketch", pass_idx=1, tiles_done=tiles_done,
                            rows_done=rows_done,
                            payload=lambda: resil.state_to_payload(state))
            if ck is not None:
                # pass boundary: a resume never re-enters the sketch pass
                ck.commit(phase="sketch", pass_idx=1, tiles_done=tiles_done,
                          rows_done=rows_done,
                          payload=lambda: resil.state_to_payload(state))
        if passes == 1:
            return done(stream.svd(state, rank))

        def accumulate_b(q):
            b = torch.zeros((q.shape[1], n_cols), dtype=torch.float32,
                            device=dev)
            for _, off, blk in tiles():                # B = Q^T A, tiled
                b += _dot(q[off:off + blk.shape[0]].T, blk)
            return b

        if tol is not None:
            return _adaptive_rsvd(
                stream, key, state, rank, tol=tol, p_cap=p_cap, fro2=fro2,
                tiles=tiles, accumulate_b=accumulate_b, n_rows=n_rows,
                n_cols=n_cols, method=method, dist=dist,
                omega_dtype=omega_dtype, return_info=return_info, device=dev)

        if ck is not None and passes == 2 and power_resume is None:
            # The B pass checkpoints a tile at a time: B's f32 sum depends
            # on its order, so the partial B and the cursor are the
            # checkpoint and the replay adds the same remaining terms.  Q is
            # not stored: it is recomputed from the checkpointed state.
            # The algebra of streamed_power_factor's last on-rows pass.
            q = stream.range_basis(state)
            if b_resume is not None:
                b, tiles_done, rows_done = b_resume
            else:
                b = torch.zeros((q.shape[1], n_cols), dtype=torch.float32,
                                device=dev)
                tiles_done = rows_done = 0

            def b_payload():
                arrays, meta = resil.state_to_payload(state)
                arrays["b"] = b            # commit copies it to the host
                return arrays, meta

            for i, off, blk in tiles(tiles_done, rows_done):
                b += _dot(q[off:off + blk.shape[0]].T, blk)
                tiles_done, rows_done = i + 1, off + int(blk.shape[0])
                ck.tick(phase="b", pass_idx=2, tiles_done=tiles_done,
                        rows_done=rows_done, payload=b_payload)
            u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
            u = _dot(q, u_b)
            return done(SVDResult(u[:, :rank], s[:rank], vt[:rank, :]))

        def accumulate_y(z):
            # tiles cover the rows in order: Y = A.Z is the per-tile
            # products stacked
            return torch.cat([_dot(blk, z) for _, _, blk in tiles()], dim=0)

        on_pass_done = None
        if ck is not None:
            def on_pass_done(pass_idx, which, basis):
                # power passes checkpoint at pass boundaries: each basis is
                # a whole orthonormal factor, so a resume replays at most
                # one pass
                ck.commit(phase="power", pass_idx=pass_idx, tiles_done=0,
                          rows_done=0,
                          payload=lambda: ({"basis": basis},
                                           {"power": {"which": which}}))

        if power_resume is not None:
            basis = resil.array_to_tensor(power_resume.arrays["basis"], dev)
            which = power_resume.meta["power"]["which"]
            return done(streamed_power_factor(
                basis if which == "q" else None, rank, passes,
                accumulate_b=accumulate_b, accumulate_y=accumulate_y,
                start_pass=power_resume.pass_idx + 1,
                z=basis if which == "z" else None,
                start_on_rows=(which == "q"), on_pass_done=on_pass_done))

        q = stream.range_basis(state)
        del state               # Y is not needed past Q: O((m+n).p) on the card
        return done(streamed_power_factor(
            q, rank, passes, accumulate_b=accumulate_b,
            accumulate_y=accumulate_y, on_pass_done=on_pass_done))


def _adaptive_rsvd(stream, key, state, rank, *, tol, p_cap, fro2, tiles,
                   accumulate_b, n_rows, n_cols, method, dist, omega_dtype,
                   return_info, device):
    """The widening loop behind ``rsvd_streamed(tol=...)``.  One B = Q^T A
    replay per evaluated width gives the exact truncation error; while it
    exceeds ``tol`` the sketch doubles its oversampling: through
    ``SketchState.widen`` (only the new lattice columns) under kernel 2, by
    re-sketching at the new width for the other methods and for SRHT (whose
    entries scale with the total width).  The working state always equals a
    fresh sketch at its width.  The Halko Eq. (4) diagnostic is reported for
    ``dist="gaussian"`` only (``core.structured.ESTIMATOR_VALIDITY``)."""
    fro2 = torch.clamp(fro2, min=0.0)
    bound_ok = _sx.halko_bound_valid(dist)
    est_hist, bound_hist = [], []
    widen_passes = grown_cols = grown_bytes = full_bytes = 0
    while True:
        q = stream.range_basis(state)
        b = accumulate_b(q)
        u_b, sv, vt = torch.linalg.svd(b, full_matrices=False)
        head2 = torch.sum(torch.square(sv[:rank]))
        denom = torch.sqrt(torch.clamp(fro2, min=1e-30))
        est = float(torch.sqrt(torch.clamp(fro2 - head2, min=0.0)) / denom)
        est_hist.append(est)
        s_now = state.p - rank
        bound_hist.append(
            float(halko_bound(torch.linalg.norm(sv[rank:]), rank, s_now)
                  / denom) if bound_ok and s_now >= 2 else None)
        converged = est <= tol
        if converged or state.p >= p_cap:
            break
        extra = min(state.p, p_cap - state.p)   # double the width, capped
        p_new = state.p + extra
        if method == "shgemm_fused" and dist != "srht":
            ext = state.widen(extra)            # only the new columns
            for _, off, blk in tiles():
                stream.update(ext, blk, off)
            state = stream.hstack(state, ext)
            grown_bytes += 4 * n_rows * extra
        else:
            state = stream.init(key, n_cols, p_new, max_rows=n_rows,
                                method=method, dist=dist,
                                omega_dtype=omega_dtype, device=device)
            for _, off, blk in tiles():
                stream.update(state, blk, off)
            grown_bytes += 4 * n_rows * p_new
        full_bytes += 4 * n_rows * p_new
        grown_cols += extra
        widen_passes += 1
    u = _dot(q, u_b)
    res = SVDResult(u[:, :rank], sv[:rank], vt[:rank, :])
    if not return_info:
        return res
    return res, AdaptiveInfo(
        final_p=state.p, widen_passes=widen_passes, converged=converged,
        est_history=tuple(est_hist), bound_history=tuple(bound_hist),
        grown_cols=grown_cols, grown_sketch_bytes=grown_bytes,
        full_resketch_bytes=full_bytes,
        bound_reason=_sx.bound_invalid_reason(dist))


def streamed_power_factor(q, rank: int, passes: int, *, accumulate_b,
                          accumulate_y, start_pass: int = 2, z=None,
                          start_on_rows: bool = True,
                          on_pass_done=None) -> SVDResult:
    """Multi-pass driver of streamed power iteration: alternate the row
    basis Q (m, p) and the column basis Z (n, p), one stream over the tiles
    a pass, from the orthonormal sketch basis ``q`` after pass 1.
    B = Q^T A doubles as Z = A^T Q = B^T, so each half-step costs one pass;
    an odd last pass factorizes from the column basis via A.Z = Q.R =>
    A ~ Q R Z^T.  ``accumulate_b(q)`` streams once and returns B = Q^T A
    (p, n); ``accumulate_y(z)`` streams once and returns Y = A.Z (m, p).

    Resume hooks: each pass but the last ends in one orthonormal basis (Q
    after an off-rows pass, Z after an on-rows pass), its successor's whole
    state.  ``on_pass_done(pass_idx, which, basis)`` (``which`` in
    ``{"q", "z"}``) hands it to a checkpointer; a resumed job re-enters the
    schedule through ``start_pass`` and the saved basis (``q`` with
    ``start_on_rows=True``, ``z`` with ``start_on_rows=False``), bit for bit
    the uninterrupted schedule, as each pass is a function of its entry
    basis and the tiles.
    """
    on_rows = start_on_rows
    if on_rows and q is None:
        raise ValueError("start_on_rows=True needs the row basis q")
    if not on_rows and z is None:
        raise ValueError("start_on_rows=False needs the column basis z")
    for pass_idx in range(start_pass, passes + 1):
        last = pass_idx == passes
        if on_rows:
            b = accumulate_b(q)
            if last:
                u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
                u = _dot(q, u_b)
                return SVDResult(u[:, :rank], s[:rank], vt[:rank, :])
            z, _ = torch.linalg.qr(b.T)                # orth(A^T Q)
            on_rows = False
            if on_pass_done is not None:
                on_pass_done(pass_idx, "z", z)
        else:
            y = accumulate_y(z)
            if last:
                q, r = torch.linalg.qr(y)
                u_r, s, wt = torch.linalg.svd(r, full_matrices=False)
                return SVDResult(_dot(q, u_r)[:, :rank], s[:rank],
                                 _dot(wt, z.T)[:rank, :])
            q, _ = torch.linalg.qr(y)
            on_rows = True
            if on_pass_done is not None:
                on_pass_done(pass_idx, "q", q)
    raise AssertionError("unreachable")  # the loop returns on the last pass


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
