"""KV-cache compression with the paper's mixed-precision sketch (port of
``repro/serve/kv_compress.py``).

A slot's per-layer K (and V) history per head is a tall (S, hd) matrix; it
is factored K ~ (U S) V^T at rank r and kept as (us = U S, vt) — memory
r (S + hd) / (S hd) of the original — and attended in factored form
(q K^T = (q vt^T) us^T).  Compression is incremental: a per-head streaming
sketch Y = K.Omega (``stream.SketchState``, method ``"shgemm"``: the
paper's split GEMM, as in the reference) absorbs rows as tokens land, and
``kv_sketch_factor`` finalizes sketch -> QR -> small SVD on demand.

Sliding-window (ring) cache leaves get the rolling variants
(``kv_rolling_*``) over ``stream/rolling.py``'s ring of per-row sketches:
the sketch ring mirrors the cache ring, and finalizing factors the current
window.  ``compress_kv_cache`` is the one-shot rSVD of a whole cache.

Heads are a batch dimension here (the reference vmaps per-head states).
Omega comes from the counter lattice, one draw per (slot, leaf) state
(``stream.init``), not from ``jax.random.split``; ``compress_kv_cache``'s
per-(batch, head) keys come from ``stream.state.fold_in_words`` (lattice
stream 8): documented deviations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import stream
from repro_torch.core import rsvd as rsvd_mod
from repro_torch.stream.state import _concrete_int, fold_in_words


class FactoredKV(NamedTuple):
    us: torch.Tensor   # (..., S, r)  U * S
    vt: torch.Tensor   # (..., r, d)


def factor_bytes(comp_len: int, rank: int, head_dim: int) -> int:
    """Bytes one head's f32 FactoredKV holds for a ``comp_len``-row
    compressed prefix: us (comp_len, r) + vt (r, head_dim)."""
    return (comp_len * rank + rank * head_dim) * 4


def compress_matrix(key, m: torch.Tensor, rank: int) -> FactoredKV:
    """One-shot rank-r factors of ``m`` with the mixed-precision rSVD."""
    res = rsvd_mod.rsvd(key, m.float(), rank,
                        oversample=min(8, max(2, rank // 4)), method="shgemm",
                        device=m.device)
    return FactoredKV(res.u * res.s[None, :], res.vt)


def reconstruct(f: FactoredKV) -> torch.Tensor:
    return f.us @ f.vt


def factored_scores(q: torch.Tensor, f: FactoredKV) -> torch.Tensor:
    """q: (..., d) -> scores (..., S) without materializing K."""
    qv = torch.einsum("...d,rd->...r", q.float(), f.vt)
    return torch.einsum("...r,sr->...s", qv, f.us)


def compression_error(m: torch.Tensor, f: FactoredKV) -> torch.Tensor:
    m = m.float()
    return torch.linalg.norm(m - reconstruct(f)) / torch.linalg.norm(m)


def _sketch_width(rank: int, head_dim: int) -> int:
    return min(rank + min(8, max(2, rank // 4)), head_dim)


def kv_sketch_init(key, n_heads: int, head_dim: int, max_seq: int, rank: int,
                   *, method: str = "shgemm", device=None) -> stream.SketchState:
    """Head-batched streaming sketch state for one (slot, layer) KV history:
    Y_h = K_h . Omega_h, (n_heads, max_seq, p) — the factor basis, not the
    history."""
    return stream.init(key, head_dim, _sketch_width(rank, head_dim),
                       max_rows=max_seq, method=method, heads=n_heads,
                       device=device)


def kv_sketch_append(states: stream.SketchState, rows: torch.Tensor,
                     pos) -> stream.SketchState:
    """Absorb newly appended tokens: ``rows`` (n_heads, T, head_dim) written
    at ABSOLUTE sequence position ``pos`` (row 0 of the slot's history, also
    after a compression swap: the i-th post-swap tail row lives at
    comp_len + i).  Cost O(T . head_dim . p)."""
    if rows.ndim != 3:
        raise ValueError(f"kv_sketch_append takes (n_heads, T, head_dim) "
                         f"rows, got shape {tuple(rows.shape)}")
    cpos = stream.state._concrete_int(pos)
    if cpos + rows.shape[1] > states.max_rows:
        raise ValueError(
            f"append at absolute position {cpos} (+{rows.shape[1]} rows) "
            f"overruns max_seq={states.max_rows} — pos is the absolute "
            f"history offset (sequence origin), not a dense-tail-relative "
            f"one; a post-swap tail row i lives at comp_len + i")
    return stream.update(states, rows.float(), cpos)


def _factor_one(s: stream.SketchState, m: torch.Tensor, rank: int) -> FactoredKV:
    """Rank-``rank`` factors of the (batched) history ``m`` (..., S, d)
    against its accumulated sketch: Q = qr(Y), B = Q^T m, SVD of B."""
    q = stream.range_basis(s)                          # (..., max_seq, p)
    # Mask unseen rows: with fewer streamed rows than the sketch width, QR
    # emits junk columns supported on them, which would dot stale cache
    # content into B.
    seen = (torch.arange(m.shape[-2], device=m.device) < s.rows_seen)[:, None]
    m = torch.where(seen, m, torch.zeros((), dtype=m.dtype, device=m.device))
    b = q.transpose(-1, -2) @ m                        # (..., p, d)
    u_b, sv, vt = torch.linalg.svd(b, full_matrices=False)
    us = (q @ u_b[..., :rank]) * sv[..., None, :rank]
    return FactoredKV(us, vt[..., :rank, :])


def kv_sketch_factor(states: stream.SketchState, hist: torch.Tensor,
                     rank: int) -> FactoredKV:
    """Finalize per-head factors from the accumulated sketches.  ``hist``
    (n_heads, S, head_dim) is the live history (after a swap: the
    reconstructed prefix plus the dense tail); rows the sketch never saw are
    masked out, so the factors depend only on the streamed rows."""
    return _factor_one(states, hist.float(), rank)


# -- sliding-window (rolling) per-head sketches -----------------------------

def kv_rolling_init(key, n_heads: int, head_dim: int, window: int, rank: int,
                    *, method: str = "shgemm", decay: float = 1.0,
                    device=None) -> stream.RollingSketchState:
    """Head-batched rolling sketch state for one (slot, layer) sliding-window
    KV history.  Ring capacity equals the cache window, so sketch eviction
    tracks cache overwrite exactly; finalizing equals a fresh sketch of the
    current window (``stream/rolling.py``)."""
    return stream.rolling_init(key, head_dim, _sketch_width(rank, head_dim),
                               window=window, method=method, decay=decay,
                               heads=n_heads, device=device)


def kv_rolling_append(states: stream.RollingSketchState, rows: torch.Tensor,
                      pos) -> stream.RollingSketchState:
    """Absorb window-layer tokens: ``rows`` (n_heads, T, head_dim) at
    absolute history position ``pos`` (the origin of ``kv_sketch_append``;
    the ring slot is ``pos % window``, mirroring the cache's own ring).

    The monotone-append guard is checked here, as the reference hoists it
    out of its per-head vmap (the heads share one clock)."""
    if rows.ndim != 3:
        raise ValueError(f"kv_rolling_append takes (n_heads, T, head_dim) "
                         f"rows, got shape {tuple(rows.shape)}")
    cpos = _concrete_int(pos)
    if cpos < states.rows_seen:
        raise ValueError(
            f"append at absolute position {cpos} is behind the rolling "
            f"sketch's high-water mark {states.rows_seen} — rewriting ring "
            f"history would corrupt the eviction order (rolling appends "
            f"must be monotone)")
    return stream.rolling_update(states, rows.float(), cpos)


def kv_rolling_factor(states: stream.RollingSketchState, hist: torch.Tensor,
                      rank: int) -> FactoredKV:
    """Per-head factors of the current window.  ``hist`` (n_heads, window,
    head_dim) must be window-ordered (oldest live row first:
    ``ModelStep._kv_ring_hist`` rotates the cache ring); the finalized
    rolling sketch is the fresh sketch of that window, so this is
    ``kv_sketch_factor`` on the window matrix."""
    return _factor_one(stream.rolling_finalize(states), hist.float(), rank)


def compress_kv_cache(key, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      rank: int) -> dict:
    """k/v (B, S, KV, hd) -> per-(batch, head) one-shot factors: {"k": ...,
    "v": ...} FactoredKV with us (B, KV, S, r) and vt (B, KV, r, hd).  The
    (batch, head) pair i = b * KV + h sketches with ``fold_in_words(key,
    i)``; K and V of a pair share the key, as in the reference."""
    b, _, kv, _ = k_cache.shape
    out = {}
    for name, cache in (("k", k_cache), ("v", v_cache)):
        parts = [compress_matrix(fold_in_words(key, i * kv + h),
                                 cache[i, :, h].float(), rank)
                 for i in range(b) for h in range(kv)]
        out[name] = FactoredKV(
            torch.stack([f.us for f in parts]).reshape(
                (b, kv) + tuple(parts[0].us.shape)),
            torch.stack([f.vt for f in parts]).reshape(
                (b, kv) + tuple(parts[0].vt.shape)))
    return out
