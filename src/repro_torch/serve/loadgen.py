"""Seeded, replayable load generation for the serving stack (port of
``repro/serve/loadgen.py``; numpy only, the same draws in the same order).

A trace is a list of ``TraceRequest`` — arrival time (seconds, Poisson
process: exponential inter-arrival gaps at ``arrival_rate`` req/s), a random
prompt of mixed length, and a target output length.  Everything is drawn
from one ``np.random.default_rng(seed)``, so the same (seed, n_requests,
rate, distribution) tuple regenerates the identical trace on any host, in
either package; ``save_trace``/``load_trace`` round-trip a trace through
JSON, and a file saved by one package is byte for byte the other's.

Length distributions are bimodal by default ("chat" short prompts mixed
with "doc" long prompts), the mixed workload the scheduler's chunked
prefill exists for: long prompts must not stall short requests' decodes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch._atomic_io import atomic_write_json


@dataclasses.dataclass
class TraceRequest:
    rid: int
    arrival_s: float          # absolute arrival time from trace start
    prompt: list[int]
    max_new: int


def generate_trace(seed: int, n_requests: int, arrival_rate: float, *,
                   vocab: int = 256,
                   prompt_short: tuple[int, int] = (4, 12),
                   prompt_long: tuple[int, int] = (24, 48),
                   long_frac: float = 0.25,
                   max_new_range: tuple[int, int] = (4, 24)) -> list[TraceRequest]:
    """Seeded Poisson-arrival trace: ``n_requests`` requests at
    ``arrival_rate`` req/s, prompts drawn bimodally (``long_frac`` of
    requests from the ``prompt_long`` length range, the rest from
    ``prompt_short``), output budgets uniform over ``max_new_range``.
    Deterministic in all arguments; token ids are uniform over
    [1, vocab) (0 is conventionally reserved for padding)."""
    if n_requests < 1:
        raise ValueError(f"n_requests={n_requests} must be >= 1")
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate={arrival_rate} must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / arrival_rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    arrivals[0] = 0.0                      # first request opens the trace
    is_long = rng.random(n_requests) < long_frac
    plens = np.where(
        is_long,
        rng.integers(prompt_long[0], prompt_long[1] + 1, size=n_requests),
        rng.integers(prompt_short[0], prompt_short[1] + 1, size=n_requests))
    max_news = rng.integers(max_new_range[0], max_new_range[1] + 1,
                            size=n_requests)
    out = []
    for i in range(n_requests):
        prompt = rng.integers(1, vocab, size=int(plens[i])).tolist()
        out.append(TraceRequest(rid=i, arrival_s=float(arrivals[i]),
                                prompt=[int(t) for t in prompt],
                                max_new=int(max_news[i])))
    return out


def save_trace(trace: list[TraceRequest], path: str,
               meta: Optional[dict] = None) -> None:
    """Write a trace as replayable JSON: {"meta": ..., "requests": [...]}."""
    payload = {
        "meta": meta or {},
        "requests": [dataclasses.asdict(r) for r in trace],
    }
    atomic_write_json(path, payload, indent=0)


def load_trace(path: str) -> list[TraceRequest]:
    with open(path) as f:
        payload = json.load(f)
    reqs = payload["requests"] if isinstance(payload, dict) else payload
    return [TraceRequest(rid=int(r["rid"]), arrival_s=float(r["arrival_s"]),
                         prompt=[int(t) for t in r["prompt"]],
                         max_new=int(r["max_new"]))
            for r in reqs]
