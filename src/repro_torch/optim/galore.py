"""GaLore-style low-rank projected optimizer on the paper's range finder
(port of ``repro/optim/galore.py``).

For every 2-D weight W (d_out x d_in) with min(W.shape) >= 64, gradients
are projected into a rank-r subspace, P^T g, with P from the randomized
range finder of the gradient (``core.rsvd.range_finder``: the paper's
mixed-precision projection, Alg. 1 lines 1-2); Adam's moments live in the
rank-r space (r/d of full Adam's memory) and the update is projected back.
P refreshes on steps t with ``t % refresh_every == 1``, from the current
gradient.  With ``method="shgemm_fused"`` the range finder's Omega is hashed
inside kernel 2 and never stored in device memory; ``shgemm_pallas`` runs
kernel 1 on a materialized Omega.  Every other leaf gets plain Adam.

The refresh is a Python branch (the reference's ``lax.cond``), so the range
finder runs on refresh steps only.  Its key for leaf i (the leaf's index in
sorted name order, the reference's flatten order) at step t is
``fold_in(fold_in(PRNGKey(1729), t), i)``, derived by
``stream.state.fold_in_words`` (counter lattice stream 8, a documented
deviation from ``jax.random.fold_in``).  P^T g and P . update are f32
products (``kernels.ref.dot_f32``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.convert import key_from_seed
from repro_torch.core import rsvd as rsvd_mod
from repro_torch.core.projection import ProjectionMethod
from repro_torch.kernels.ref import dot_f32
from repro_torch.optim.optimizers import Optimizer, step_counter
from repro_torch.stream import state as _st

KEY_SEED = 1729


def _is_matrix(p) -> bool:
    return p.ndim == 2 and min(p.shape) >= 64


class _Leaf(NamedTuple):
    proj: Optional[torch.Tensor]   # (d, r) orthonormal basis, or None
    m: torch.Tensor
    v: torch.Tensor


def galore(lr: float = 3e-4, rank: int = 64, refresh_every: int = 200,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           method: ProjectionMethod = "shgemm",
           oversample: int = 8) -> Optimizer:
    def leaf_init(p):
        if _is_matrix(p):
            r = min(rank, min(p.shape))
            tall = p.shape[0] >= p.shape[1]
            d, other = (p.shape if tall else p.shape[::-1])
            z = dict(dtype=torch.float32, device=p.device)
            return _Leaf(torch.zeros((d, r), **z), torch.zeros((r, other), **z),
                         torch.zeros((r, other), **z))
        return _Leaf(None, torch.zeros_like(p), torch.zeros_like(p))

    def init(params):
        return {"leaves": {k: leaf_init(p) for k, p in params.items()},
                "t": step_counter(),
                "key": torch.tensor(key_from_seed(KEY_SEED),
                                    dtype=torch.uint32)}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.float()
        step_key = _st.fold_in_words(state["key"], int(t))
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        refresh = (int(t) % refresh_every) == 1

        def leaf_update(g, s, i):
            if s.proj is None:
                m = b1 * s.m + (1 - b1) * g
                v = b2 * s.v + (1 - b2) * g * g
                upd = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                return upd, _Leaf(None, m, v)
            tall = g.shape[0] >= g.shape[1]
            gm = (g if tall else g.T).float()
            r = s.proj.shape[1]
            proj = s.proj
            if refresh:
                proj = rsvd_mod.range_finder(
                    _st.fold_in_words(step_key, i), gm, r,
                    oversample=oversample, method=method,
                    device=gm.device)[:, :r].float()
            g_low = dot_f32(proj.T, gm)            # (r, d_in) = P^T g
            m = b1 * s.m + (1 - b1) * g_low
            v = b2 * s.v + (1 - b2) * g_low * g_low
            upd_low = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            upd = -lr * dot_f32(proj, upd_low)     # back-project
            upd = (upd if tall else upd.T).to(g.dtype)
            return upd, _Leaf(proj, m, v)

        outs = {k: leaf_update(grads[k], state["leaves"][k], i)
                for i, k in enumerate(sorted(grads))}
        return ({k: o[0] for k, o in outs.items()},
                {"leaves": {k: o[1] for k, o in outs.items()}, "t": t,
                 "key": state["key"]})

    return Optimizer(init, update)


def optimizer_state_bytes(params, rank: int = 64) -> tuple[int, int]:
    """(adam_bytes, galore_bytes): the memory claim of the integration."""
    adam = galore_b = 0
    for p in params.values():
        n = p.numel() * 4 * 2  # m + v in f32
        adam += n
        if _is_matrix(p):
            d = max(p.shape)
            r = min(rank, min(p.shape))
            galore_b += (d * r + 2 * r * min(p.shape)) * 4
        else:
            galore_b += n
    return adam, galore_b
