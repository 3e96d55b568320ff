"""Finalizers computed from accumulated sketch state alone (port of
``repro/stream/finalize.py:range_basis``; the single-pass ``svd`` needs the
left sketch, which waits for ROADMAP Queue 1 item 12)."""

from __future__ import annotations

import torch

from repro_torch.stream.state import SketchState


def range_basis(state: SketchState) -> torch.Tensor:
    """Q (..., max_rows, p) with orthonormal columns such that A ~ Q Q^T A.

    Rows of Y beyond the streamed ones are zero.  With fewer than p streamed
    rows Y is rank-deficient and QR emits junk trailing columns supported on
    the unseen rows, so consumers that project cache-resident data through
    Q must mask rows beyond ``rows_seen`` (``serve.kv_compress._factor_one``
    does).  With >= p streamed rows the unseen rows of Q are exactly zero.
    """
    q, _ = torch.linalg.qr(state.y.float())
    return q
