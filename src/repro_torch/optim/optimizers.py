"""Minimal functional optimizers (port of ``repro/optim/optimizers.py``).

AdamW (the default), Adafactor (factored second moment, the memory-lean
baseline GaLore is compared against) and SGD.  Each is an ``Optimizer`` of
two pure functions, ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, over flat dicts of tensors keyed like the
params; nothing is updated in place, so a caller may retry a step from the
state it holds.  States mirror the reference's pytrees leaf for leaf (what
``train.checkpoint`` writes and ``convert.opt_state_from_reference``
reads).  The step counter ``t`` is an int32 scalar tensor on the CPU: the
update reads it on the host (GaLore's refresh is a Python branch), and a
CPU scalar combines with tensors on any device.

Under an active mesh (``sharding.activation``) the params, gradients and
AdamW's moments are each rank's slices: AdamW and SGD work element by
element, so nothing changes.  Adafactor's factored statistics are means
over whole rows and columns: it keeps them whole on every rank, as the
reference does (``rules.opt_state_specs``: ``"s"`` replicated), summing a
mean over a split dim across the ranks that split it, so a sharded step is
the one-process step.  It reads the params' layout from
``activation.set_param_specs``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sharding import activation as A


class Optimizer(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]


def step_counter() -> torch.Tensor:
    """The state's step counter at 0: an int32 scalar on the CPU."""
    return torch.zeros((), dtype=torch.int32)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()},
                "t": step_counter()}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.float()
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * g * g
             for k, g in grads.items()}
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        updates = {k: -lr * ((m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                             + weight_decay * params[k]) for k in grads}
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def _layout(params: dict) -> dict:
    """Each leaf's stored spec under the active mesh (None entries without
    one)."""
    mesh = A.get_mesh()
    if mesh is None:
        return {k: (None,) * p.ndim for k, p in params.items()}
    specs = A.get_param_specs()
    if specs is None:
        raise ValueError("Adafactor under a mesh needs the params' specs: "
                         "register them with activation.set_param_specs")
    return {k: tuple(specs[k]) for k in params}


def _whole(x: torch.Tensor, spec) -> torch.Tensor:
    return A.gather_leaf(x, spec, A.get_mesh()) if any(spec) else x


def _part(x: torch.Tensor, spec) -> torch.Tensor:
    return A.slice_leaf(x, spec, A.get_mesh()) if any(spec) else x


def _mean(x: torch.Tensor, dim: int, entry, n: int) -> torch.Tensor:
    """The mean over ``dim`` of the whole leaf, whose length is ``n`` and
    which is split over ``entry`` (an axis, a tuple or None)."""
    if entry is None:
        return torch.mean(x, dim=dim)
    return A.all_reduce(torch.sum(x, dim=dim), A.get_mesh(), entry) / n


def adafactor(lr: float = 3e-4, eps: float = 1e-30,
              decay: float = 0.8) -> Optimizer:
    """Factored second moment for >= 2-D params: O(r + c) state instead of
    O(rc)."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def leaf(p, spec):
        shape = A.whole_shape(p.shape, spec, A.get_mesh())
        if _factored(shape):
            return {"vr": p.new_zeros(shape[:-1], dtype=torch.float32),
                    "vc": p.new_zeros(shape[:-2] + shape[-1:],
                                      dtype=torch.float32)}
        return {"v": p.new_zeros(shape, dtype=torch.float32)}

    def init(params):
        lay = _layout(params)
        return {"s": {k: leaf(p, lay[k]) for k, p in params.items()},
                "t": step_counter()}

    def update(grads, state, params):
        t = state["t"] + 1
        beta = 1.0 - (t.float() + 1.0) ** -decay
        lay = _layout(grads)

        def upd(g, s, spec):
            g2 = g.float() ** 2 + eps
            if _factored(g.shape):
                rows, cols = spec[:-1], spec[:-2] + spec[-1:]
                vr = beta * s["vr"] + (1 - beta) * _whole(
                    _mean(g2, -1, spec[-1], s["vc"].shape[-1]), rows)
                vc = beta * s["vc"] + (1 - beta) * _whole(
                    _mean(g2, -2, spec[-2], s["vr"].shape[-1]), cols)
                denom = (_part(vr, rows)[..., None] * _part(vc, cols)[..., None, :]
                         / torch.clamp(_part(torch.mean(vr, dim=-1, keepdim=True),
                                             spec[:-2] + (None,))[..., None],
                                       min=eps))
                u = g / torch.sqrt(denom + eps)
                return -lr * u.to(g.dtype), {"vr": vr, "vc": vc}
            v = beta * s["v"] + (1 - beta) * _whole(g2, spec)
            return -lr * (g / torch.sqrt(_part(v, spec) + eps)).to(g.dtype), {"v": v}

        outs = {k: upd(g, state["s"][k], lay[k]) for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                {"s": {k: o[1] for k, o in outs.items()}, "t": t})

    return Optimizer(init, update)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"t": step_counter()}

    def update(grads, state, params):
        return {k: -lr * g for k, g in grads.items()}, {"t": state["t"] + 1}

    return Optimizer(init, update)


def get(name: str, lr: float) -> Optimizer:
    if name == "adamw":
        return adamw(lr)
    if name == "adafactor":
        return adafactor(lr)
    if name == "sgd":
        return sgd(lr)
    raise ValueError(f"unknown optimizer {name!r}")
