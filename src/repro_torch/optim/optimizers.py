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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


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


def adafactor(lr: float = 3e-4, eps: float = 1e-30,
              decay: float = 0.8) -> Optimizer:
    """Factored second moment for >= 2-D params: O(r + c) state instead of
    O(rc)."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def leaf(p):
        if _factored(p.shape):
            return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    def init(params):
        return {"s": {k: leaf(p) for k, p in params.items()},
                "t": step_counter()}

    def update(grads, state, params):
        t = state["t"] + 1
        beta = 1.0 - (t.float() + 1.0) ** -decay

        def upd(g, s):
            g2 = g.float() ** 2 + eps
            if _factored(g.shape):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)
                                       [..., None], min=eps))
                u = g / torch.sqrt(denom + eps)
                return -lr * u.to(g.dtype), {"vr": vr, "vc": vc}
            v = beta * s["v"] + (1 - beta) * g2
            return -lr * (g / torch.sqrt(v + eps)).to(g.dtype), {"v": v}

        outs = {k: upd(g, state["s"][k]) for k, g in grads.items()}
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
