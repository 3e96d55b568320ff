"""Finalizers computed from accumulated sketch state alone (port of
``repro/stream/finalize.py``).

``range_basis`` needs only the right sketch Y; ``svd`` is the single-pass
randomized SVD of Tropp et al. (2017): Q from Y, then the small system
``(Psi.Q) X = W`` gives the rank-p core without a second look at A.  Psi.Q
is one more kernel-2 sketch of Q^T with the fused method.

Departure from the reference: the core solve uses ``torch.linalg.pinv``
(``jnp.linalg.lstsq``'s SVD-based solution; ``torch.linalg.lstsq`` on CUDA
has only the full-rank QR driver).
"""

from __future__ import annotations

import torch

from repro_torch.core import projection as proj
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm_fused as _kf
from repro_torch.kernels.ref import dot_f32 as _dot
from repro_torch.stream.state import SketchState, _psi_s


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


def psi_times(state: SketchState, m: torch.Tensor) -> torch.Tensor:
    """Psi . M for a (max_rows, c) matrix M, as (M^T . Psi^T)^T: kernel 2
    with the fused method, else Psi^T from the same counter lattice through
    the method's GEMM."""
    if state.key_psi is None:
        raise ValueError("state has no left sketch (init(left=True))")
    if state.method == "shgemm_fused":
        return ops.shgemm_fused(m.T, state.key_psi, state.l, dist=state.dist,
                                omega_dtype=state.omega_dtype,
                                s=_psi_s(state), device=state.device).T
    psi_t = _kf.reference_omega(state.key_psi, (m.shape[0], state.l),
                                dist=state.dist, s=_psi_s(state),
                                dtype=state.omega_dtype, device=state.device)
    return proj.project(m.T, psi_t, method=state.method,
                        device=state.device).T


def svd(state: SketchState, rank: int):
    """Single-pass randomized SVD from (Y, W), A never revisited (Tropp et
    al. 2017, Alg. 7): Q = orth(Y); solve (Psi Q) X = W in least squares;
    SVD the (p, n_cols) core X; A ~ Q X.  Needs ``init(left=True)``.
    Returns ``core.rsvd.SVDResult``."""
    from repro_torch.core.rsvd import SVDResult  # rsvd imports stream
    if state.w is None:
        raise ValueError(
            "single-pass svd needs the left sketch: build the state with "
            "stream.init(..., left=True), or use core.rsvd.rsvd_streamed "
            "with a replayable tile stream for the two-pass variant")
    if rank > state.p:
        raise ValueError(f"rank={rank} exceeds sketch width p={state.p}")
    q = range_basis(state)                      # (m, p)
    psi_q = psi_times(state, q)                 # (l, p)
    u_t, t = torch.linalg.qr(psi_q)             # (l, p), (p, p)
    # X = T^+ (U^T W): the pseudo-inverse tolerates a rank-deficient sketch
    # (a matrix of rank < p) where a triangular solve would blow up.
    x = _dot(torch.linalg.pinv(t), _dot(u_t.T, state.w))   # (p, n_cols)
    u_x, s, vt = torch.linalg.svd(x, full_matrices=False)
    u = _dot(q, u_x)
    return SVDResult(u[:, :rank], s[:rank], vt[:rank, :])
