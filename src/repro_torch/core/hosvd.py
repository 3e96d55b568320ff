"""Random-projection HOSVD (paper Algorithm 2) and tensor utilities (port of
``repro/core/hosvd.py``).

RP-HOSVD factorizes A in R^{I1 x ... x IN} as a core tensor contracted with
orthonormal factors Q_k, from one random projection + QR per mode.  The
mode-k projection W = A_(k) . Omega_(k) is the O(prod(I) * J_k) hot spot and
runs through the mixed-precision sketch.

Documented deviation: the reference derives the per-mode keys with
``jax.random.split(key, ndim)``, which torch cannot reproduce.  The port
derives them in ``_mode_keys`` by counter-hashing the key words with the
mode index on stream 6 of the fused kernel's lattice (a stream no
distribution uses).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import projection as proj
from repro_torch.core import structured as _sx
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import shgemm_fused as _f
from repro_torch.kernels.ref import dot_f32 as _dot

_MODE_KEY_STREAM = 6


class TuckerResult(NamedTuple):
    core: torch.Tensor                 # (J1, ..., JN)
    factors: tuple[torch.Tensor, ...]  # Q_k: (I_k, J_k)


def unfold(t: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-k unfolding: (I_k, prod_{j!=k} I_j)."""
    perm = (mode,) + tuple(i for i in range(t.ndim) if i != mode)
    return t.permute(perm).reshape(t.shape[mode], -1)


def fold(m: torch.Tensor, mode: int, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of unfold."""
    full = (shape[mode],) + tuple(s for i, s in enumerate(shape) if i != mode)
    t = m.reshape(full)
    inv = list(range(1, mode + 1)) + [0] + list(range(mode + 1, len(shape)))
    return t.permute(inv)


def mode_dot(t: torch.Tensor, m: torch.Tensor, mode: int) -> torch.Tensor:
    """Contraction T x_k M with M: (J, I_k), applied as M . T_(k)."""
    res = _dot(m, unfold(t, mode))
    new_shape = list(t.shape)
    new_shape[mode] = m.shape[0]
    return fold(res, mode, new_shape)


def _mode_keys(key, ndim: int) -> list[tuple[int, int]]:
    """Per-mode key words: (bits(i, 0), bits(i, 1)) of the key's lattice on
    stream 6 (the port's stand-in for ``jax.random.split``)."""
    k0, k1 = _f.key_pair(key)
    rows = torch.arange(ndim, dtype=torch.int64)[:, None]
    cols = torch.arange(2, dtype=torch.int64)[None, :]
    words = _f.counter_bits(k0, k1, rows, cols, _MODE_KEY_STREAM)
    return [tuple(int(w) for w in row) for row in words.tolist()]


def _mode_sketch(key, core: torch.Tensor, i: int, rank: int, *, method, dist,
                 omega_dtype) -> torch.Tensor:
    """W = A_(i) . Omega_i for one mode: the per-mode hot GEMM, or the
    Khatri-Rao factor-by-factor contraction that replaces it.  With
    ``dist="khatri_rao"`` neither the (I_i, prod I_k) unfolding nor the
    (prod I_k, J_i) Omega is ever formed."""
    if dist == "khatri_rao":
        kro = _sx.KhatriRaoOmega(key=key, dims=tuple(core.shape), mode=i,
                                 p=rank, device=core.device)
        return kro.sketch_slab(core)
    return proj.sketch(key, unfold(core, i), rank, method=method, dist=dist,
                       omega_dtype=omega_dtype, device=core.device)


def rp_hosvd(key, a, ranks: tuple[int, ...], *,
             method: proj.ProjectionMethod = "shgemm",
             dist: proj.SketchDist = "gaussian", omega_dtype=torch.bfloat16,
             device=None) -> TuckerResult:
    """Paper Algorithm 2: per mode W = A_(i) . Omega_i, Q_i <- QR(W); then
    core g = A x_1 Q_1^T ... x_N Q_N^T."""
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    keys = _mode_keys(key, a.ndim)
    factors = []
    for i in range(a.ndim):
        w = _mode_sketch(keys[i], a, i, ranks[i], method=method, dist=dist,
                         omega_dtype=omega_dtype)                # line 2
        q, _ = torch.linalg.qr(w)                                # line 3
        factors.append(q)
    core = a
    for i, q in enumerate(factors):
        core = mode_dot(core, q.T, i)                            # line 5
    return TuckerResult(core, tuple(factors))


def rp_sthosvd(key, a, ranks: tuple[int, ...], *,
               method: proj.ProjectionMethod = "shgemm",
               dist: proj.SketchDist = "gaussian", omega_dtype=torch.bfloat16,
               device=None) -> TuckerResult:
    """Sequentially truncated variant: each mode's projection runs on the
    already-compressed tensor, cutting the later GEMMs."""
    dev = resolve_device(device)
    core = on_device(a, dev).to(torch.float32)
    keys = _mode_keys(key, core.ndim)
    factors = []
    for i in range(core.ndim):
        w = _mode_sketch(keys[i], core, i, ranks[i], method=method, dist=dist,
                         omega_dtype=omega_dtype)
        q, _ = torch.linalg.qr(w)
        factors.append(q)
        core = mode_dot(core, q.T, i)
    return TuckerResult(core, tuple(factors))


def rp_sthosvd_streamed(key, slabs, dims=None, ranks=None, *,
                        method: proj.ProjectionMethod = "shgemm_fused",
                        dist: proj.SketchDist = "gaussian",
                        omega_dtype=torch.bfloat16,
                        prefetch_depth: int | None = 1,
                        tol: float | None = None, max_ranks=None,
                        checkpoint_dir=None,
                        checkpoint_every_tiles: int | None = None,
                        resume: bool = False, return_report: bool = False,
                        device=None) -> TuckerResult:
    """Single-pass streaming Tucker of a tensor that arrives as slabs along
    axis 0 (``repro_torch.stream.tucker``).

    ``slabs`` is anything ``stream.as_tile_source`` accepts, tiling axis 0
    exactly; ``dims`` may be omitted when the source knows its shape.  Slabs
    are prefetched to ``device`` (``prefetch_depth=None`` disables); at most
    ``prefetch_depth + 1`` slabs live beside the O(sum_i I_i.J_i) sketch
    state, and the per-mode Omega_i is regenerated block-wise in kernel 2
    (or contracted factor by factor with ``dist="khatri_rao"``).

    Adaptive ranks (``tol=..., max_ranks=...``): sketch once at the per-mode
    ceilings and let :func:`truncate_tucker` pick each mode's rank at
    finalize.

    Fault tolerance (``checkpoint_dir=...``): the job is one slab pass over
    a TuckerSketch, checkpointed with its slab cursor every
    ``checkpoint_every_tiles`` slabs (default 16); ``resume=True`` goes on
    from the last checkpoint and the result equals the uninterrupted run's
    bit for bit (the replay keeps the slab order).  ``tol=`` composes with
    it: the widths are fixed at init.  A fault that raises reaches the
    caller after the pending checkpoint writes are on disk.
    ``return_report=True`` returns ``(TuckerResult, ResilienceReport)``.
    """
    from repro_torch import stream  # stream imports this module
    from repro_torch.core.rsvd import _check_checkpoint_args
    if tol is not None:
        if ranks is not None:
            raise ValueError("pass either fixed ranks= or adaptive "
                             "tol=+max_ranks=, not both")
        if max_ranks is None:
            raise ValueError("adaptive mode (tol=) needs max_ranks= — the "
                             "per-mode sketch widths / rank ceilings")
        if float(tol) <= 0.0:
            raise ValueError(f"tol must be > 0, got {tol}")
        ranks = tuple(int(r) for r in max_ranks)
    elif max_ranks is not None:
        raise ValueError("max_ranks only applies to adaptive (tol=...) "
                         "runs")
    if ranks is None:
        raise TypeError("rp_sthosvd_streamed missing required ranks")
    dev = resolve_device(device)
    try:
        src = stream.as_tile_source(
            slabs, shape=tuple(int(d) for d in dims) if dims is not None
            else None)
    except ValueError as e:
        if dims is None and "shape" in str(e):
            raise ValueError(
                "this slab stream cannot be inspected for its shape: pass "
                "dims= (or stream from a TileSource/array/.npy path, "
                "which knows its shape)") from e
        raise
    if dims is not None and tuple(int(d) for d in dims) != src.shape:
        raise ValueError(f"dims={tuple(dims)} but the slab source has "
                         f"shape {src.shape}")
    dims = src.shape
    _check_checkpoint_args(checkpoint_dir, checkpoint_every_tiles, resume,
                           return_report)
    ck = None
    if checkpoint_dir is not None:
        from repro_torch.stream import resilience as resil
        if not src.replayable:
            raise ValueError(
                "checkpoint_dir needs a replayable slab source: resuming "
                "replays the slab suffix after the checkpointed cursor, "
                "which a one-shot generator cannot provide")
        fingerprint = {
            "job": "rp_sthosvd_streamed",
            "key": resil.key_fingerprint(key),
            "dims": [int(d) for d in dims],
            "ranks": [int(r) for r in ranks],
            "method": str(method), "dist": str(dist),
            "omega_dtype": resil.dtype_name(omega_dtype),
            **resil.omega_fingerprint(method),
        }
        ck = resil.SketchJobCheckpointer(
            checkpoint_dir,
            every_tiles=(16 if checkpoint_every_tiles is None
                         else checkpoint_every_tiles),
            fingerprint=fingerprint, resume=resume)

    with ck if ck is not None else contextlib.nullcontext():
        tiles_done = rows_done = 0
        restored = ck.restore() if ck is not None else None
        if restored is not None:
            if restored.phase != "tucker":
                raise RuntimeError(f"checkpoint under {checkpoint_dir} is "
                                   f"in unknown phase {restored.phase!r}")
            ts = resil.tucker_from_payload(restored.arrays, restored.meta,
                                           device=dev)
            tiles_done, rows_done = restored.tiles_done, restored.rows_done
        else:
            ts = stream.tucker_init(key, dims, ranks, method=method,
                                    dist=dist, omega_dtype=omega_dtype,
                                    device=dev)
        t_last = time.perf_counter()
        for off, slab in stream.offset_tiles(
                src, prefetch_depth=prefetch_depth, device=dev,
                start_row=rows_done):
            stream.tucker_update(ts, slab, off)
            tiles_done, rows_done = tiles_done + 1, off + int(slab.shape[0])
            if ck is not None:
                now = time.perf_counter()
                ck.note_tile(now - t_last)
                t_last = now
                ck.tick(phase="tucker", pass_idx=1, tiles_done=tiles_done,
                        rows_done=rows_done,
                        payload=lambda: resil.tucker_to_payload(ts))
        res = stream.tucker_finalize(ts)
        if tol is not None:
            res = truncate_tucker(res, tol)
        if ck is None:
            return res
        # a last commit at the end of the stream: a rerun from it
        # recomputes no slab
        ck.commit(phase="tucker", pass_idx=1, tiles_done=tiles_done,
                  rows_done=rows_done,
                  payload=lambda: resil.tucker_to_payload(ts))
        report = ck.finish(tiles_total=resil._count_tiles(src) or tiles_done)
    return (res, report) if return_report else res


def truncate_tucker(res: TuckerResult, tol: float, *,
                    min_rank: int = 1) -> TuckerResult:
    """Per-mode adaptive rank truncation: rotate each mode into the core's
    singular basis and keep the smallest rank whose discarded tail fits that
    mode's share of the error budget (tail² <= tol²·||core||²/N)."""
    if tol <= 0.0:
        raise ValueError(f"tol must be > 0, got {tol}")
    core = res.core.to(torch.float32)
    factors = list(res.factors)
    ndim = core.ndim
    total2 = float(torch.sum(core * core))
    budget2 = (float(tol) ** 2) * total2 / ndim
    for i in range(ndim):
        u, s, _ = torch.linalg.svd(unfold(core, i), full_matrices=False)
        s2 = s.detach().cpu().numpy().astype(np.float64) ** 2
        revcum = np.cumsum(s2[::-1])[::-1]  # revcum[r] = sum_{j>=r} s2[j]
        keep = len(s2)
        for r in range(max(1, int(min_rank)), len(s2)):
            if revcum[r] <= budget2:
                keep = r
                break
        factors[i] = _dot(factors[i], u[:, :keep])
        core = mode_dot(core, u[:, :keep].T, i)
    return TuckerResult(core, tuple(factors))


def reconstruct(res: TuckerResult) -> torch.Tensor:
    t = res.core
    for i, q in enumerate(res.factors):
        t = mode_dot(t, q, i)
    return t


def reconstruction_error(a: torch.Tensor, res: TuckerResult) -> torch.Tensor:
    a = a.to(torch.float32)
    return torch.linalg.norm(a - reconstruct(res)) / torch.linalg.norm(a)


def make_test_tensor(gen: torch.Generator, dims: Sequence[int],
                     ranks: Sequence[int], pad: int = 2) -> torch.Tensor:
    """Paper Algorithm 3: low-multilinear-rank test tensor on ``gen.device``.

    G ~ U(-1,1)^{J1 x ... x JN}; per mode contract with a (J_i - pad)-rank
    matrix Omega_b . Omega_a mapping J_i -> I_i.
    """
    def unif(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
        return u * 2.0 - 1.0
    g = unif(tuple(ranks))
    for i, (ii, ji) in enumerate(zip(dims, ranks)):
        oa = unif((ji - pad, ji))
        ob = unif((ii, ji - pad))
        g = mode_dot(g, _dot(ob, oa), i)
    return g
