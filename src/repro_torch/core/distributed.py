"""Distributed RandNLA over ``torch.distributed``: sharded mixed-precision
projection, TSQR, RSVD (port of ``repro/core/distributed.py``).

The reference's ``shard_map`` bodies become each rank's own code (SPMD): a
rank holds its block of A on a (data, model) :class:`HostMesh` (rows over
data, columns over model; ``shard_matrix``) and calls the same functions as
every other rank, whose collectives run in the mesh's process groups.

  * Projection Y = A . Omega: each rank runs the local mixed-precision
    SHGEMM of its block (kernel 1 for ``method="shgemm_pallas"``; kernel 2
    for ``"shgemm_fused"``, which hashes the rank's Omega row block at
    ``row_offset = model_index * n_loc`` on the card), then one
    ``all_reduce`` over ``model``.  Nothing of Omega is materialized or
    communicated under kernel 2; the other methods draw the global Omega
    through ``projection.materialize_omega`` and take their row block.
  * QR of the tall-skinny Y by TSQR over ``data``: local QR, ``all_gather``
    of the p x p R factors, QR of the stack, local Q update.  Collective
    volume is O(dp * p^2), independent of m.
  * B = Q^T A: local GEMM and ``all_reduce`` over ``data``; the SVD of B by
    a second TSQR of B^T over ``model`` (no Gram squaring).

``distributed_rsvd_streamed`` stays the reference's single-controller
driver: one process loops over the per-host tile sources, merges pass 1 by
a host-order fold of ``stream.merge`` (exact for disjoint rows) and joins
the later passes' per-host partials in host order on the device; its mesh
is an unbound ``HostMesh`` (names and sizes).  ``stream.merge_across_hosts``
is the collective merge of a real multi-process world.

Departures from the reference: the non-fused methods' Omega is the port's
counter-lattice draw (``core/projection.py``), so those paths agree with the
reference to a tolerance, not in bits; the drivers take ``device=`` for the
single-controller path; a rank's Omega row offset off kernel 2's ``bk`` grid
goes through ``stream.state.fused_at_row_offset``.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import projection as proj
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dot_f32 as _dot
from repro_torch.launch.mesh import HostMesh


class ShardedSVD(NamedTuple):
    u: torch.Tensor    # (m_loc, rank): this rank's rows (sharded over data)
    s: torch.Tensor    # (rank,) replicated
    vt: torch.Tensor   # (rank, n_loc): this rank's columns (over model)


def shard_matrix(a, mesh: HostMesh, data_axis: str = "data",
                 model_axis: str = "model") -> torch.Tensor:
    """This rank's block of the (m, n) matrix ``a`` in the library's 2-D
    layout: rows split evenly over ``data_axis``, columns over
    ``model_axis`` (a contiguous copy)."""
    m, n = a.shape
    dp, mp = mesh.size(data_axis), mesh.size(model_axis)
    if m % dp or n % mp:
        raise ValueError(f"a {m}x{n} matrix does not split evenly over a "
                         f"{dp} x {mp} ({data_axis}, {model_axis}) mesh")
    i, j = mesh.index(data_axis), mesh.index(model_axis)
    m_loc, n_loc = m // dp, n // mp
    return a[i * m_loc:(i + 1) * m_loc, j * n_loc:(j + 1) * n_loc].contiguous()


def _global_shape(a_blk: torch.Tensor, mesh: HostMesh, data_axis: str,
                  model_axis: str) -> tuple[int, int]:
    m_loc, n_loc = a_blk.shape
    return m_loc * mesh.size(data_axis), n_loc * mesh.size(model_axis)


def _all_reduce(x: torch.Tensor, mesh: HostMesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (in place; the reference's psum)."""
    dist.all_reduce(x, group=mesh.group(axis))
    return x


def _local_project(a_blk, om_blk, method: str, mesh: HostMesh,
                   model_axis: str) -> torch.Tensor:
    """Per-rank projection of the block, summed over the model axis."""
    y = proj.project(a_blk, om_blk, method=method, device=a_blk.device)
    return _all_reduce(y.contiguous(), mesh, model_axis)


def _local_sketch_fused(a_blk, key, p_hat: int, mesh: HostMesh,
                        model_axis: str, omega_dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """Per-rank fused projection: kernel 2 hashes this rank's Omega row
    block from (key, global row offset ``model_index * n_loc``) on the card,
    bit for bit ``fused_omega(key, (n, p_hat))[off:off + n_loc]``, so nothing
    of Omega is stored or sent; then the sum over the model axis."""
    from repro_torch.stream.state import fused_at_row_offset
    a_blk = a_blk.to(torch.float32)
    m_loc, n_loc = a_blk.shape
    off = mesh.index(model_axis) * n_loc
    if off % ops.fused_plan(m_loc, p_hat, n_loc)[2] == 0:
        y = ops.shgemm_fused(a_blk, key, p_hat, omega_dtype=omega_dtype,
                             row_offset=off, device=a_blk.device)
    else:
        y = fused_at_row_offset(a_blk, key, p_hat, off,
                                omega_dtype=omega_dtype)
    return _all_reduce(y.contiguous(), mesh, model_axis)


def _omega_block(key, n: int, p_hat: int, mesh: HostMesh, model_axis: str,
                 n_loc: int, omega_dtype, device) -> torch.Tensor:
    """This rank's row block of the materialized Omega of the non-fused
    methods (every rank draws the same (n, p_hat) Omega)."""
    omega = proj.materialize_omega(key, (n, p_hat), dtype=omega_dtype,
                                   device=device)
    off = mesh.index(model_axis) * n_loc
    return omega[off:off + n_loc]


def _tsqr(y_blk: torch.Tensor, mesh: HostMesh, axis: str
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR across ``axis``; y_blk: (m_loc, p), m_loc >= p."""
    p = y_blk.shape[1]
    if y_blk.shape[0] < p:
        raise ValueError(f"TSQR needs at least {p} local rows, this rank "
                         f"holds {y_blk.shape[0]}")
    q1, r1 = torch.linalg.qr(y_blk)                   # local QR
    r1 = r1.contiguous()
    r_all = [torch.empty_like(r1) for _ in range(mesh.size(axis))]
    dist.all_gather(r_all, r1, group=mesh.group(axis))  # (dp, p, p): tiny
    q2, r = torch.linalg.qr(torch.cat(r_all))         # (dp * p, p) QR
    idx = mesh.index(axis)
    return _dot(q1, q2[idx * p:(idx + 1) * p]), r


def _sketch(key, a_blk, p_hat: int, mesh: HostMesh, *, method: str,
            omega_dtype, data_axis: str, model_axis: str) -> torch.Tensor:
    """This rank's rows of Y = A . Omega(key)[:, :p_hat]."""
    if method == "shgemm_fused":
        return _local_sketch_fused(a_blk, key, p_hat, mesh, model_axis,
                                   omega_dtype=omega_dtype)
    n = _global_shape(a_blk, mesh, data_axis, model_axis)[1]
    om_blk = _omega_block(key, n, p_hat, mesh, model_axis, a_blk.shape[1],
                          omega_dtype, a_blk.device)
    return _local_project(a_blk, om_blk, method, mesh, model_axis)


def distributed_range_finder(key, a_blk: torch.Tensor, p_hat: int,
                             mesh: HostMesh, *, method: str = "shgemm",
                             omega_dtype=torch.bfloat16,
                             data_axis: str = "data",
                             model_axis: str = "model") -> torch.Tensor:
    """This rank's rows of Q (m, p_hat), sharded over data, with
    A ~ Q Q^T A.  With ``method="shgemm_fused"`` no Omega exists anywhere:
    each rank hashes its row block inside kernel 2."""
    a_blk = a_blk.to(torch.float32)
    y = _sketch(key, a_blk, p_hat, mesh, method=method,
                omega_dtype=omega_dtype, data_axis=data_axis,
                model_axis=model_axis)
    q, _ = _tsqr(y, mesh, data_axis)
    return q


def distributed_rsvd(key, a_blk: torch.Tensor, rank: int, mesh: HostMesh, *,
                     oversample: int = 10, power_iters: int = 0,
                     method: str = "shgemm", data_axis: str = "data",
                     model_axis: str = "model") -> ShardedSVD:
    """Randomized SVD of a 2-D-sharded A, called on every rank with its
    block ``a_blk`` (``shard_matrix``); nothing larger than the block or
    p_hat^2 replicated is held by a rank.

    ``power_iters``: q passes of the (A A^T)^q scheme (paper §2.1), each two
    sharded GEMMs and a TSQR re-orthogonalization.  ``method="shgemm_fused"``
    generates each rank's Omega row block inside kernel 2; every other
    method projects a row block of the materialized Omega (bf16)."""
    a_blk = a_blk.to(torch.float32)
    m, n = _global_shape(a_blk, mesh, data_axis, model_axis)
    p_hat = min(rank + oversample, min(m, n))
    # Lines 1-2: projection and TSQR over data.
    y = _sketch(key, a_blk, p_hat, mesh, method=method,
                omega_dtype=torch.bfloat16, data_axis=data_axis,
                model_axis=model_axis)
    q, _ = _tsqr(y, mesh, data_axis)                          # (m_loc, p_hat)
    for _ in range(power_iters):
        z = _all_reduce(_dot(a_blk.T, q), mesh, data_axis)    # A^T q
        z, _ = _tsqr(z, mesh, model_axis)
        y = _all_reduce(_dot(a_blk, z), mesh, model_axis)     # A z
        q, _ = _tsqr(y, mesh, data_axis)
    # Line 3: B = Q^T A, columns sharded over model.
    b_blk = _all_reduce(_dot(q.T, a_blk), mesh, data_axis)
    # Line 4 without Gram squaring: TSQR of B^T over model, B = R^T Q_bt^T,
    # then the small SVD of R^T.
    q_bt, r_bt = _tsqr(b_blk.T.contiguous(), mesh, model_axis)
    u_b, s, wt = torch.linalg.svd(r_bt.T, full_matrices=False)
    vt_blk = _dot(wt, q_bt.T)                                 # (p, n_loc)
    u = _dot(q, u_b)
    return ShardedSVD(u[:, :rank], s[:rank], vt_blk[:rank, :])


def _dist_payload(resil, done, cur, host):
    """Checkpoint payload of the distributed sketch pass (the reference's
    layout): the fold-merge of the finished hosts (``done.*``), the
    in-flight host's partial (``cur.*``) and the host the cursor is in."""
    arrays, meta = {}, {}
    if done is not None:
        arrays, meta = resil.state_to_payload(done, prefix="done")
    if cur is not None:
        a2, m2 = resil.state_to_payload(cur, prefix="cur")
        arrays.update(a2)
        meta.update(m2)
    meta["cursor"] = {"host": int(host)}
    return arrays, meta


def distributed_rsvd_streamed(key, sources, rank: int, mesh: HostMesh, *,
                              oversample: int = 10, passes: int = 2,
                              method: str = "shgemm_fused",
                              omega_dtype=torch.bfloat16,
                              data_axis: str = "data",
                              prefetch_depth: int | None = 1,
                              checkpoint_dir=None,
                              checkpoint_every_tiles: int | None = None,
                              resume: bool = False,
                              return_report: bool = False, device=None):
    """Multi-host x out-of-core randomized SVD, on one controller: each
    host of ``mesh``'s ``data_axis`` streams its own tile source (a
    disjoint global row range of A, in global row order) and the per-host
    sketches are merged; every later pass accumulates per-host partials
    joined in host order.

    ``sources``: one tile source per host, source i covering rows
    ``[sum_{j<i} rows_j, ...)``; each must be replayable (``passes >= 2``)
    and may have its own tiling.  ``mesh`` is a ``HostMesh`` (unbound: its
    names and sizes) whose ``data_axis`` has one entry per source.  Under
    ``method="shgemm_fused"`` every host hashes its tiles' Omega row blocks
    inside kernel 2 at their global offsets, and the merged sketch equals
    single-host ``rsvd_streamed``'s of the concatenated source bit for bit.
    ``passes`` as in ``rsvd_streamed`` (>= 2).

    Fault tolerance (``checkpoint_dir=...``): pass 1 checkpoints at tile
    granularity (the fold-merge of the finished hosts, the in-flight host's
    partial state and the cursor, in the reference's layout, so a
    checkpoint crosses between the packages for ``shgemm_fused``); later
    passes at pass boundaries.  ``resume=True`` restarts from the last
    checkpoint; ``return_report=True`` also returns a
    ``stream.resilience.ResilienceReport``.  Returns a ``core.rsvd.SVDResult``
    on ``device`` (``None``: CUDA).
    """
    from repro_torch import stream      # deferred: stream imports core modules
    from repro_torch.core.rsvd import _check_checkpoint_args, \
        _check_rank, streamed_power_factor
    from repro_torch.stream import resilience as resil

    if passes < 2:
        raise ValueError("distributed_rsvd_streamed needs passes >= 2; the "
                         "strict single-pass finalizer is single-host "
                         "(stream.svd) — merge left-sketch states with "
                         "merge_across_hosts directly instead")
    dev = resolve_device(device)
    srcs = [stream.as_tile_source(s) for s in sources]
    if data_axis not in mesh.axis_names or mesh.size(data_axis) != len(srcs):
        raise ValueError(f"{len(srcs)} tile sources need a {data_axis!r} "
                         f"mesh axis of size {len(srcs)}, got mesh "
                         f"{mesh.shape}")
    bad = [i for i, s in enumerate(srcs) if not s.replayable]
    if bad:
        raise ValueError(f"passes={passes} must replay every tile stream; "
                         f"sources {bad} are not replayable")
    n_cols = srcs[0].n_cols
    for i, s in enumerate(srcs):
        if s.n_cols != n_cols:
            raise ValueError(f"source {i} has {s.n_cols} columns, "
                             f"source 0 has {n_cols}")
    row_starts, m = [], 0
    for s in srcs:
        row_starts.append(m)
        m += s.n_rows
    _check_rank(rank, m, n_cols)
    p_hat = min(rank + oversample, min(m, n_cols))
    _check_checkpoint_args(checkpoint_dir, checkpoint_every_tiles, resume,
                           return_report)

    ck = None
    if checkpoint_dir is not None:
        fingerprint = {
            "job": "distributed_rsvd_streamed",
            "key": resil.key_fingerprint(key),
            "rank": int(rank), "p_hat": int(p_hat), "passes": int(passes),
            "method": str(method),
            "omega_dtype": resil.dtype_name(omega_dtype),
            "n_rows": int(m), "n_cols": int(n_cols), "hosts": len(srcs),
            **resil.omega_fingerprint(method),
        }
        ck = resil.SketchJobCheckpointer(
            checkpoint_dir,
            every_tiles=(16 if checkpoint_every_tiles is None
                         else checkpoint_every_tiles),
            fingerprint=fingerprint, resume=resume)

    def fresh_state():
        return stream.init(key, n_cols, p_hat, max_rows=m, method=method,
                           omega_dtype=omega_dtype, device=dev)

    def host_tiles(h, start_local=0):
        t_last = time.perf_counter()
        for off, blk in stream.offset_tiles(
                srcs[h], prefetch_depth=prefetch_depth, device=dev,
                start_row=start_local):
            yield row_starts[h] + off, blk.to(device=dev, dtype=torch.float32)
            if ck is not None:
                now = time.perf_counter()
                ck.note_tile(now - t_last)
                t_last = now

    def finished(res):
        if ck is None:
            return res
        report = ck.finish(tiles_total=sum(
            resil._count_tiles(s) or 0 for s in srcs) * passes)
        return (res, report) if return_report else res

    # Passes 2..: the shared power-iteration driver (core.rsvd owns the
    # algebra), each accumulation built a host at a time and the per-host
    # partials joined in host order.
    def accumulate_b(q):
        parts = []
        for h in range(len(srcs)):
            b_h = torch.zeros((q.shape[1], n_cols), dtype=torch.float32,
                              device=dev)
            for off, blk in host_tiles(h):
                b_h += _dot(q[off:off + blk.shape[0]].T, blk)
            parts.append(b_h)
        b = parts[0]
        for b_h in parts[1:]:
            b = b + b_h                                       # B = Q^T A
        return b

    def accumulate_y(z):
        # each host's rows are its own: the join of the per-host partials
        # of Y = A.Z is their concatenation in host order (the sum of the
        # zero-padded partials, bit for bit)
        return torch.cat([_dot(blk, z) for h in range(len(srcs))
                          for _, blk in host_tiles(h)], dim=0)

    on_pass_done = None
    if ck is not None:
        def on_pass_done(pass_idx, which, basis):
            ck.commit(phase="power", pass_idx=pass_idx, tiles_done=0,
                      rows_done=0,
                      payload=lambda: ({"basis": basis},
                                       {"power": {"which": which}}))

    with ck if ck is not None else contextlib.nullcontext():
        restored = ck.restore() if ck is not None else None
        if restored is not None and restored.phase == "power":
            basis = resil.array_to_tensor(restored.arrays["basis"], dev)
            which = restored.meta["power"]["which"]
            return finished(streamed_power_factor(
                basis if which == "q" else None, rank, passes,
                accumulate_b=accumulate_b, accumulate_y=accumulate_y,
                start_pass=restored.pass_idx + 1,
                z=basis if which == "z" else None,
                start_on_rows=(which == "q"), on_pass_done=on_pass_done))
        if restored is not None and restored.phase != "dist-sketch":
            raise RuntimeError(f"checkpoint under {checkpoint_dir} is in "
                               f"unknown phase {restored.phase!r}")

        # Pass 1: per-host sketches over the global Omega lattice, folded
        # into ``done`` in host order (disjoint rows: bit for bit the
        # collective sum); checkpointed at tile granularity as the
        # fold-merge of the finished hosts, the in-flight host's partial
        # and its cursor.
        done, cur0 = None, None
        h_start, local_start, g_tiles = 0, 0, 0
        if restored is not None:
            if "done.y" in restored.arrays:
                done = resil.state_from_payload(restored.arrays,
                                                restored.meta, "done", dev)
            if "cur.y" in restored.arrays:
                cur0 = resil.state_from_payload(restored.arrays,
                                                restored.meta, "cur", dev)
            h_start = int(restored.meta["cursor"]["host"])
            g_tiles = restored.tiles_done
            if h_start < len(srcs):
                local_start = restored.rows_done - row_starts[h_start]
        for h in range(h_start, len(srcs)):
            if h == h_start and cur0 is not None:
                st, start_local = cur0, local_start
            else:
                st, start_local = fresh_state(), 0
            for off, blk in host_tiles(h, start_local):
                stream.update(st, blk, off)
                g_tiles += 1
                if ck is not None:
                    ck.tick(phase="dist-sketch", pass_idx=1,
                            tiles_done=g_tiles,
                            rows_done=int(off + blk.shape[0]),
                            payload=lambda d=done, c=st, hh=h:
                                _dist_payload(resil, d, c, hh))
            done = st if done is None else stream.merge(done, st)
        merged = done
        if ck is not None:
            ck.commit(phase="dist-sketch", pass_idx=1, tiles_done=g_tiles,
                      rows_done=int(m),
                      payload=lambda: _dist_payload(resil, merged, None,
                                                    len(srcs)))
        q = stream.range_basis(merged)
        del merged, done
        return finished(streamed_power_factor(
            q, rank, passes, accumulate_b=accumulate_b,
            accumulate_y=accumulate_y, on_pass_done=on_pass_done))
