"""Arch registry and the serving steps (port of the serving part of
``repro/models/registry.py``).

``make_prefill_step`` and ``make_serve_step`` return plain functions of
(params, batch); PyTorch runs them eagerly, so there is nothing to jit.
The train step is not ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.layers import softcap


def get_arch(name: str) -> ModelCfg:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def _final_logits(cfg, logits: torch.Tensor) -> torch.Tensor:
    """Serving consumers get f32 + the final softcap."""
    return softcap(logits.float(), cfg.final_softcap)


def make_prefill_step(cfg: ModelCfg) -> Callable:
    """(params, batch{tokens}) -> (last_logits (B, V) f32, cache).

    Logits are computed at the last position only (``forward(last_only=
    True)``): the step returns no other, and the full (B, S, V) logits at
    S = 32768 would be 10 GB."""

    def step(params, batch):
        p = T.cast_params_for_compute(cfg, params)
        out = T.forward(cfg, p, batch["tokens"], return_cache=True,
                        last_only=True)
        return _final_logits(cfg, out.logits[:, -1]), out.cache

    return step


def make_serve_step(cfg: ModelCfg) -> Callable:
    """(params, batch{tokens, cache, write_pos}) -> (logits, cache).

    Optional batch keys ``kv_factors``/``comp_len`` carry the serving
    engine's compressed-prefix state; they ride through read-only.  The
    cache is updated in place and returned."""

    def step(params, batch):
        p = T.cast_params_for_compute(cfg, params)
        out = T.forward(cfg, p, batch["tokens"], cache=batch["cache"],
                        write_pos=batch["write_pos"],
                        kv_factors=batch.get("kv_factors"),
                        comp_len=batch.get("comp_len"), last_only=True)
        return _final_logits(cfg, out.logits[:, -1]), out.cache

    return step


__all__ = ["ARCHS", "get_arch", "smoke_config", "make_prefill_step",
           "make_serve_step"]
