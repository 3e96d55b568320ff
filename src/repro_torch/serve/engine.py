"""Batched serving engine: closed-loop batching over a fixed slot pool
(port of ``repro/serve/engine.py``).

A request enters a free slot, gets prefilled (its cache rows written at its
slot), then joins the batched decode step; a finished request frees its
slot for the next queue entry.  ``Engine`` inherits every tensor primitive
from ``ModelStep`` and adds the queue, slot assignment and the decode loop.
Decode rows land at the uniform slot clock max(pos), so a slot admitted
mid-stream goes non-contiguous and never compresses (DESIGN.md §12.1).
The unmasked decode step advances every slot's recurrent state, idle ones
included, so admission zeroes the slot's state before its prefill (the
reference does not: a documented deviation).

``submit`` enforces a bounded queue: past ``max_queue`` waiting requests it
raises ``QueueFullError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import cache as cache_mod
from repro_torch.serve.model_step import ModelStep
from repro_torch.serve.scheduler import QueueFullError


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine(ModelStep):
    def __init__(self, cfg: ModelCfg, params, *, slots: int = 4,
                 max_seq: int = 256, temperature: float = 0.0,
                 sample_seed: int = 0, kv_sketch_rank: Optional[int] = None,
                 kv_sketch_seed: int = 7,
                 kv_compress_ratio: Optional[float] = None,
                 max_queue: int = 1024, device=None):
        super().__init__(cfg, params, slots=slots, max_seq=max_seq,
                         temperature=temperature, sample_seed=sample_seed,
                         kv_sketch_rank=kv_sketch_rank,
                         kv_sketch_seed=kv_sketch_seed,
                         kv_compress_ratio=kv_compress_ratio, device=device)
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        self.max_queue = max_queue
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        """Enqueue a request; raises QueueFullError once ``max_queue``
        requests are already waiting."""
        if len(self.queue) >= self.max_queue:
            raise QueueFullError(req.rid, len(self.queue), self.max_queue)
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                # the last tenant's and the idle decode steps' recurrent
                # state must not reach this request (the reference keeps it)
                cache_mod.reset_slot_state(self.cache, s)
                logits = self._prefill_slot(s, req.prompt, 0)
                self.pos[s] = len(req.prompt)
                req.out.append(int(torch.argmax(logits)))
                if self.kv_sketch_rank:
                    self._reset_slot_sketches(s)
                    self._kv_pending[s] = [0, len(req.prompt)]
                    self._kv_next_row[s] = len(req.prompt)
                    self._kv_contig[s] = True
                    self._maybe_compress(s)    # long prompts swap at admit

    def step(self) -> int:
        """One batched decode step over all active slots; returns #active."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        tokens = np.zeros((self.slots, 1), np.int64)
        for s in live:
            tokens[s, 0] = self.active[s].out[-1] if self.active[s].out \
                else self.active[s].prompt[-1]
        write_pos = int(max(self.pos[s] for s in live))  # uniform slot clock
        logits = self.decode_logits(tokens, write_pos)
        nxt = self.sample(logits)
        if self.kv_sketch_rank:
            for s in live:
                self._note_kv_row(s, write_pos)
        for s in live:
            req = self.active[s]
            req.out.append(int(nxt[s]))
            self.pos[s] += 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                req.done = True
                self.active[s] = None
            elif self.kv_sketch_rank:
                self._maybe_compress(s)
        return len(live)

    def run(self) -> None:
        while self.queue or any(self.active):
            self.step()
