"""Continuous-batching request scheduler over the model-step layer (port
of ``repro/serve/scheduler.py``, the same schedule step for step).

The production serving path, in place of the Engine's whole-prompt-at-admit
loop:

- **Bounded admission**: a ``max_queue``-deep request queue; past that,
  ``submit`` refuses and the reject (with queue depth) lands in the metrics.
  (``QueueFullError`` lives here and is what ``Engine.submit`` raises.)
- **Chunked prefill interleaved with decode**: each scheduler step spends at
  most ``prefill_chunk`` prompt tokens on slots still prefilling, then runs
  one batched decode step for the slots already decoding — a long prompt
  never stalls in-flight decodes for more than one chunk.
- **Catch-up decode**: the batched decode step writes every participating
  slot's row at one shared clock position, so a freshly prefilled slot whose
  pos trails the clock would go non-contiguous — the gap that forbids
  compression.  Instead the scheduler generates that slot's output tokens
  one at a time at its own positions (single-slot steps) until its pos
  equals the clock, then promotes it into the batched decode set.  Every
  scheduler-managed slot keeps an append-only contiguous history and stays
  compressible under churn.
- **Compression-aware admission**: with an ``hbm_budget``, concurrency is
  capped at budget // per-stream worst-case swappable-KV bytes
  (``models/cache.kv_stream_bytes``) — factored slots bound far fewer bytes
  per stream, so the same budget admits more concurrent streams.
- **Deterministic virtual time**: steps advance a ``VirtualClock`` by a
  fixed ``StepCostModel``, so latency percentiles of a seeded trace are
  exact across machines and packages; wall-clock numbers are measured
  separately (``launch.serve.run_scheduler``, ``chip_smoke.py``).

Invariant the design hangs on: all slots in the decode set share one pos
(the clock) forever — each batched step writes at the common clock and
advances every member by one, members join only at pos == clock, and when
the set drains the largest-pos ready slot re-seeds the clock.  Compression
fires only at promotion and after batched decode tokens, never mid-prefill
or catch-up (the single-slot prefill step is not factor-aware: a swap would
zero dense rows that later chunks still attend).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

import torch

from repro_torch.models import cache as cache_mod
from repro_torch.serve import loadgen
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.model_step import ModelStep


class QueueFullError(RuntimeError):
    """Loud backpressure: the bounded request queue is full.  Carries the
    observed depth so producers can log or shed."""

    def __init__(self, rid: int, queue_depth: int, max_queue: int):
        self.rid = rid
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        super().__init__(
            f"request {rid} rejected: queue depth {queue_depth} at "
            f"max_queue={max_queue} (backpressure — retry later or raise "
            f"max_queue)")


@dataclasses.dataclass
class StepCostModel:
    """Deterministic per-step virtual-time costs (microseconds).  The base
    decode cost dominates the per-token cost by design: batched decode is
    memory-bound (one pass over weights + caches regardless of how many
    slots ride along), which is exactly why compression-bought concurrency
    raises aggregate tokens/sec — more tokens amortize the same base."""
    prefill_base_us: float = 150.0    # per masked single-slot dispatch
    prefill_per_token_us: float = 25.0
    decode_base_us: float = 850.0     # per batched decode step
    decode_per_token_us: float = 35.0  # per live slot in the step


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, t)


PREFILL, READY, DECODE = "prefill", "ready", "decode"


@dataclasses.dataclass
class ScheduledRequest:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    phase: str = PREFILL
    prefilled: int = 0            # prompt tokens written so far
    done: bool = False
    evicted: bool = False


class Scheduler:
    """Continuous batching over a ``ModelStep`` slot pool (see module
    docstring for the contract)."""

    def __init__(self, model: ModelStep, *, max_queue: int = 256,
                 prefill_chunk: int = 8,
                 hbm_budget: Optional[int] = None,
                 cost: Optional[StepCostModel] = None,
                 metrics: Optional[ServeMetrics] = None):
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        if prefill_chunk < 2:
            # catch-up must outpace the clock (which advances one position
            # per decode step): budget 1 would only ever tread water
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 2")
        self.model = model
        self.max_queue = max_queue
        self.prefill_chunk = prefill_chunk
        self.cost = cost or StepCostModel()
        self.clock = VirtualClock()
        self.metrics = metrics or ServeMetrics()
        self.queue: deque[ScheduledRequest] = deque()
        self.active: list[Optional[ScheduledRequest]] = [None] * model.slots
        self.finished: list[ScheduledRequest] = []
        self._decode_clock: Optional[int] = None   # shared pos of DECODE set
        # compression-aware admission: cap concurrency at what the HBM
        # budget can hold at worst case (full max_seq context per stream)
        self.hbm_budget = hbm_budget
        self.stream_bound = self._stream_bound()
        if hbm_budget is None:
            self.max_streams = model.slots
        elif self.stream_bound == 0:
            # no full-context attention k/v (recurrent and windowed layers
            # only, or windows shorter than max_seq): the reference divides
            # by zero here
            raise ValueError(
                f"hbm_budget={hbm_budget} caps nothing: {model.cfg.name} at "
                f"max_seq={model.max_seq} holds no swappable KV bytes a "
                f"stream (no full-context attention layer); run without "
                f"an hbm_budget")
        else:
            self.max_streams = min(model.slots,
                                   max(0, hbm_budget // self.stream_bound))
            if self.max_streams == 0:
                raise ValueError(
                    f"hbm_budget={hbm_budget} below one stream's worst-case "
                    f"bound {self.stream_bound} — nothing could ever be "
                    f"admitted")

    def _stream_bound(self) -> int:
        """Worst-case swappable-KV bytes one stream can hold live."""
        m = self.model
        if m.kv_fact is not None:
            # dense tail never outgrows threshold + one chunk between
            # auto-compress checks
            tail = m._kv_threshold + self.prefill_chunk
            return cache_mod.kv_stream_bytes(
                m.cfg, m.max_seq, rank=m.kv_sketch_rank, tail_rows=tail)
        return cache_mod.kv_stream_bytes(m.cfg, m.max_seq)

    # -- submission --------------------------------------------------------
    def submit(self, rid: int, prompt: list[int], max_new: int) -> bool:
        """Enqueue a request; returns False (and records the reject in the
        metrics) when the bounded queue is full — the scheduler's soft
        spelling of the same backpressure Engine.submit raises as
        QueueFullError."""
        if len(prompt) + 1 > self.model.max_seq:
            raise ValueError(f"request {rid}: prompt of {len(prompt)} "
                             f"tokens cannot fit max_seq="
                             f"{self.model.max_seq}")
        if len(self.queue) >= self.max_queue:
            self.metrics.on_reject(rid, self.clock.now, len(self.queue))
            return False
        self.queue.append(ScheduledRequest(rid=rid, prompt=list(prompt),
                                           max_new=max_new))
        self.metrics.on_submit(rid, self.clock.now, len(prompt), max_new)
        return True

    # -- lifecycle helpers -------------------------------------------------
    def _live(self) -> list[int]:
        return [s for s in range(self.model.slots)
                if self.active[s] is not None]

    def _decoding(self) -> list[int]:
        return [s for s in self._live() if self.active[s].phase == DECODE]

    def _finish(self, slot: int, *, evicted: bool = False) -> None:
        req = self.active[slot]
        req.done, req.evicted = True, evicted
        self.active[slot] = None
        self.finished.append(req)
        self.metrics.on_finish(req.rid, self.clock.now, evicted=evicted)
        if not self._decoding():
            self._decode_clock = None

    def _emit(self, slot: int, token: int) -> bool:
        """Append one generated token; returns True if the request finished
        (max_new reached or context exhausted -> evicted)."""
        req = self.active[slot]
        req.out.append(int(token))
        self.metrics.on_token(req.rid, self.clock.now)
        if len(req.out) >= req.max_new:
            self._finish(slot)
            return True
        if int(self.model.pos[slot]) >= self.model.max_seq - 1:
            self._finish(slot, evicted=True)
            return True
        return False

    def _admit(self) -> None:
        while (self.queue and len(self._live()) < self.max_streams
               and any(self.active[s] is None
                       for s in range(self.model.slots))):
            slot = next(s for s in range(self.model.slots)
                        if self.active[s] is None)
            req = self.queue.popleft()
            req.slot = slot
            self.active[slot] = req
            self.model.begin_slot(slot)   # complete reset: no prior tenant
            self.metrics.on_admit(req.rid, self.clock.now)

    # -- the step ----------------------------------------------------------
    def _prefill_work(self) -> tuple[int, int]:
        """Spend up to ``prefill_chunk`` tokens on slots still prefilling or
        catching up; returns (tokens written, dispatches made)."""
        budget = self.prefill_chunk
        tokens = calls = 0
        for slot in self._live():
            if budget <= 0:
                break
            req = self.active[slot]
            if req.phase == PREFILL:
                take = min(budget, len(req.prompt) - req.prefilled)
                logits = self.model.prefill_rows(
                    slot, req.prompt[req.prefilled:req.prefilled + take],
                    req.prefilled)
                req.prefilled += take
                budget -= take
                tokens += take
                calls += 1
                if req.prefilled == len(req.prompt):
                    req.phase = READY
                    # first output token comes from the prefill logits
                    if not self._emit(slot, self._pick(logits)):
                        pass
            req = self.active[slot]
            if req is not None and req.phase == READY:
                # catch-up: real output tokens at the slot's own positions
                # until it reaches the decode clock
                while (budget > 0 and self._decode_clock is not None
                       and int(self.model.pos[slot]) < self._decode_clock):
                    logits = self.model.prefill_rows(
                        slot, [req.out[-1]], int(self.model.pos[slot]))
                    budget -= 1
                    tokens += 1
                    calls += 1
                    if self._emit(slot, self._pick(logits)):
                        break
        return tokens, calls

    def _pick(self, logits_row: torch.Tensor) -> int:
        """Next token from a single slot's (vocab,) logits — greedy, or
        temperature-sampled through the model's generator (drawn for every
        slot, as a decode step would draw)."""
        if self.model.temperature > 0:
            rows = logits_row[None, :].expand(self.model.slots, -1)
            return int(self.model.sample(rows)[0])
        return int(torch.argmax(logits_row))

    def _promote(self) -> None:
        """Move READY slots whose pos matches the clock into the decode
        set; when the set is empty, the largest-pos ready slot re-seeds the
        clock (others then join only as the clock reaches them).  Promotion
        is the first compression point: the slot's whole contiguous history
        is sketched, so long prompts swap to factors before their first
        batched decode step."""
        ready = [s for s in self._live() if self.active[s].phase == READY]
        if not ready:
            return
        if self._decode_clock is None:
            seed = max(ready, key=lambda s: int(self.model.pos[s]))
            self._decode_clock = int(self.model.pos[seed])
        for s in ready:
            if int(self.model.pos[s]) == self._decode_clock:
                self.active[s].phase = DECODE
                self.model.auto_compress(s)

    def _decode_step(self) -> int:
        """One batched decode for the decode set at the shared clock; cache
        writes are masked to the participating slots so catching-up slots'
        histories stay exactly their own rows."""
        dec = self._decoding()
        if not dec:
            return 0
        clock = self._decode_clock
        tokens = np.zeros((self.model.slots, 1), np.int32)
        mask = np.zeros(self.model.slots, bool)
        for s in dec:
            req = self.active[s]
            tokens[s, 0] = req.out[-1] if req.out else req.prompt[-1]
            mask[s] = True
        logits = self.model.decode_logits(tokens, clock, slot_mask=mask)
        nxt = self.model.sample(logits)
        if self.model.kv_sketch_rank:
            for s in dec:
                self.model._note_kv_row(s, clock)
        for s in dec:
            self.model.pos[s] = clock + 1
            if not self._emit(s, nxt[s]) and self.model.kv_sketch_rank:
                self.model.auto_compress(s)
        if self._decoding():
            self._decode_clock = clock + 1
        return len(dec)

    def step(self) -> bool:
        """One scheduler step: admit, spend the prefill/catch-up token
        budget, promote, run one batched decode, advance virtual time by
        the step's modeled cost, sample the gauges.  Returns True if any
        work happened."""
        self._admit()
        p_tokens, p_calls = self._prefill_work()
        self._promote()
        n_dec = self._decode_step()
        if p_tokens == 0 and n_dec == 0:
            return False
        cost_us = (p_calls * self.cost.prefill_base_us
                   + p_tokens * self.cost.prefill_per_token_us)
        if n_dec:
            cost_us += (self.cost.decode_base_us
                        + n_dec * self.cost.decode_per_token_us)
        self.clock.advance(cost_us * 1e-6)
        self.metrics.sample(len(self.queue), len(self._live()),
                            self.model.kv_bytes_report()
                            if self.model.kv_sketch_rank else None)
        return True

    def run(self, trace: list[loadgen.TraceRequest]) -> ServeMetrics:
        """Replay a load trace on the virtual clock: deliver arrivals as
        virtual time passes, step until fully drained.  Deterministic in
        (trace, model config, scheduler knobs)."""
        i, n = 0, len(trace)
        while i < n or self.queue or self._live():
            while i < n and trace[i].arrival_s <= self.clock.now:
                r = trace[i]
                self.submit(r.rid, r.prompt, r.max_new)
                i += 1
            if not self.step() and i < n:
                # idle: jump to the next arrival instead of spinning
                self.clock.advance_to(trace[i].arrival_s)
        return self.metrics
