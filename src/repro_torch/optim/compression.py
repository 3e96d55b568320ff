"""Random-projection gradient compression for the data-parallel all-reduce
(port of ``repro/optim/compression.py``).

The all-reduce of a 2-D gradient g (d_out x d_in, d_out >= 256) is replaced
by the all-reduce of a rank-r sketch Q^T g, Q an orthonormal basis of a
Gaussian Omega (d_out x r) drawn from a seed shared by every rank, so Q is
never communicated.  After the reduce the sketch is un-projected, and an
error-feedback residual keeps the compression unbiased over time:

    e_t     <- g_t + e_{t-1}              (accumulate what was lost)
    sketch  <- Q^T e_t                    (r/d_out of the bytes on the wire)
    g_hat   <- Q sketch / n_dp
    e_t     <- e_t - g_hat * n_dp         (residual carried forward)

The projection Q^T e runs through ``core.projection.project`` with Q in
bf16: the paper's mixed-precision GEMM (kernel 1 for ``shgemm_pallas`` and
``shgemm_fused``).  Every other leaf is all-reduced as it is.

Where the reference names a mesh axis (``axis_name=``, a ``psum`` inside
``shard_map``), the port takes ``group=``, a ``torch.distributed`` process
group (for example a data group of ``launch.mesh.HostMesh``): sketches and
incompressible leaves are all-reduced with SUM over it, and n_dp is its
size.  Without a group the sketch and un-sketch still run (single process).
Per-step and per-leaf keys come from ``stream.state.fold_in_words``
(counter lattice stream 8, a documented deviation from
``jax.random.fold_in``); leaf i is the leaf's index in sorted name order,
the reference's flatten order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.convert import key_from_seed
from repro_torch.core import projection as proj
from repro_torch.core.projection import ProjectionMethod
from repro_torch.kernels.ref import dot_f32
from repro_torch.stream import state as _st


class CompressionState(NamedTuple):
    residual: dict           # error feedback; None for incompressible leaves
    step: torch.Tensor       # int32 scalar on the CPU


def _compressible(g) -> bool:
    return g.ndim == 2 and g.shape[0] >= 256


def init_state(grads: dict) -> CompressionState:
    res = {k: torch.zeros_like(g) if _compressible(g) else None
           for k, g in grads.items()}
    return CompressionState(res, torch.zeros((), dtype=torch.int32))


def _step_key(step: torch.Tensor, seed: int) -> tuple[int, int]:
    return _st.fold_in_words(key_from_seed(seed), int(step))


def _draw_basis(key, i: int, d: int, rank: int, method: ProjectionMethod,
                device) -> torch.Tensor:
    """The per-leaf orthonormal basis Q of one optimizer step: the one
    source of the one-shot and microbatch paths (their equivalence needs
    the identical Q).  Kernel 2's lattice Omega for ``shgemm_fused``, the
    Gaussian of ``projection.gaussian`` otherwise (the same lattice in the
    port; the reference draws it with ``jax.random``)."""
    r = min(rank, d)
    k = _st.fold_in_words(key, i)
    if method == "shgemm_fused":
        omega = proj.fused_omega(k, (d, r), dtype=torch.float32, device=device)
    else:
        omega = proj.gaussian(k, (d, r), dtype=torch.float32, device=device)
    # orthonormalize so (I - QQ^T) is a contraction: raw Omega Omega^T / r
    # has spectral radius (1 + sqrt(d/r))^2 and the residual diverges
    q_basis, _ = torch.linalg.qr(omega)
    return q_basis


def _sketch(a: torch.Tensor, q: torch.Tensor, method) -> torch.Tensor:
    """(r, d_in) = (a^T Q_bf16)^T: the mixed-precision projection of a^T."""
    return proj.project(a.T, q.to(torch.bfloat16), method=method,
                        device=a.device).T


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """SUM of ``x`` over ``group`` (a new tensor), or ``x`` without one."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _n_dp(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def compress_and_reduce(grads: dict, state: CompressionState, *,
                        rank: int = 32, group=None,
                        method: ProjectionMethod = "shgemm",
                        seed: int = 42) -> tuple[dict, CompressionState]:
    """Returns (reduced_grads, new_state).  With ``group`` the sketches are
    summed over it; without, single-process mode (the sketch and un-sketch
    still run, which is how the unit tests check the estimator)."""
    step = state.step + 1
    key = _step_key(step, seed)
    n_dp = _n_dp(group)
    reduced, new_res = {}, {}
    for i, k in enumerate(sorted(grads)):
        g, e = grads[k], state.residual[k]
        if e is None:
            reduced[k], new_res[k] = _sum(g, group), None
            continue
        q_basis = _draw_basis(key, i, g.shape[0], rank, method, g.device)
        acc = g.float() + e
        sketch = _sum(_sketch(acc, q_basis, method), group)
        g_hat = dot_f32(q_basis, sketch) / n_dp
        new_res[k] = acc - g_hat * n_dp
        reduced[k] = g_hat.to(g.dtype)
    return reduced, CompressionState(new_res, step)


# ---------------------------------------------------------------------------
# Streaming microbatch accumulation (``stream``'s linearity applied to
# gradient sketches): each microbatch's sketch Q^T g_j is accumulated as it
# is produced, the all-reduce runs once on the accumulated sketch, and the
# microbatch gradients can be freed at once.  Equal to
# ``compress_and_reduce(sum_j g_j, state)`` up to f32 summation order.
# ---------------------------------------------------------------------------

class MicrobatchSketch(NamedTuple):
    bases: dict       # per-leaf (d, r) f32 orthonormal Q (None: incompressible)
    sketches: dict    # per-leaf (r, d_in) accumulated Q^T (e + sum g_j)
    raw: dict         # per-leaf accumulated raw grads of incompressible leaves
    residual: dict    # per-leaf e + sum_j g_j so far (the EF accumulator)
    like: dict        # per-leaf dtype of the gradient leaves
    step: torch.Tensor
    n_micro: torch.Tensor


def begin_accumulation(state: CompressionState, grads_like: dict, *,
                       rank: int = 32, method: ProjectionMethod = "shgemm",
                       seed: int = 42) -> MicrobatchSketch:
    """Open the accumulation window of the optimizer step after
    ``state.step``.  ``grads_like`` gives the gradients' names, shapes and
    dtypes (its values are ignored).  Q is drawn as ``compress_and_reduce``
    draws it for this step, and the sketches start at Q^T e, the error
    feedback, so ``finish_accumulation`` reproduces its result."""
    step = state.step + 1
    key = _step_key(step, seed)
    bases, sketches, raw, residual = {}, {}, {}, {}
    for i, k in enumerate(sorted(grads_like)):
        g, e = grads_like[k], state.residual[k]
        if e is None:
            bases[k], sketches[k], raw[k], residual[k] = (
                None, None, torch.zeros_like(g), None)
            continue
        q_basis = _draw_basis(key, i, g.shape[0], rank, method, g.device)
        bases[k], sketches[k], raw[k], residual[k] = (
            q_basis, _sketch(e, q_basis, method), None, e)
    return MicrobatchSketch(bases, sketches, raw, residual,
                            {k: g.dtype for k, g in grads_like.items()}, step,
                            torch.zeros((), dtype=torch.int32))


def accumulate_microbatch(ms: MicrobatchSketch, grads: dict, *,
                          method: ProjectionMethod = "shgemm"
                          ) -> MicrobatchSketch:
    """Absorb one microbatch's gradients: compressible leaves add the
    mixed-precision sketch Q^T g and fold g into the error-feedback
    accumulator; incompressible leaves accumulate raw."""
    sketches, raw, residual = dict(ms.sketches), dict(ms.raw), dict(ms.residual)
    for k, g in grads.items():
        q = ms.bases[k]
        if q is None:
            raw[k] = raw[k] + g
            continue
        g32 = g.float()
        sketches[k] = sketches[k] + _sketch(g32, q, method)
        residual[k] = residual[k] + g32
    return ms._replace(sketches=sketches, raw=raw, residual=residual,
                       n_micro=ms.n_micro + 1)


def finish_accumulation(ms: MicrobatchSketch, *, group=None
                        ) -> tuple[dict, CompressionState]:
    """Close the window: all-reduce the accumulated sketches (the only wire
    traffic of compressible leaves), reconstruct g_hat and update the
    residual.  Returns ``(reduced_grads, CompressionState)``, what
    ``compress_and_reduce`` returns for the summed gradient."""
    n_dp = _n_dp(group)
    reduced, new_res = {}, {}
    for k in sorted(ms.bases):
        q = ms.bases[k]
        if q is None:
            reduced[k], new_res[k] = _sum(ms.raw[k], group), None
            continue
        g_hat = dot_f32(q, _sum(ms.sketches[k], group)) / n_dp
        new_res[k] = ms.residual[k] - g_hat * n_dp
        reduced[k] = g_hat.to(ms.like[k])
    return reduced, CompressionState(new_res, ms.step)


def wire_bytes(grads: dict, rank: int = 32) -> tuple[int, int]:
    """(uncompressed, compressed) bytes of one data-parallel reduce: the
    claim."""
    full = comp = 0
    for g in grads.values():
        full += g.numel() * 4
        if _compressible(g):
            comp += min(rank, g.shape[0]) * g.shape[1] * 4
        else:
            comp += g.numel() * 4
    return full, comp
