"""Training loop with fault tolerance and a straggler watch (port of
``repro/train/loop.py``).

  * checkpoint/restart: ``train.checkpoint.CheckpointManager``
    (asynchronous, atomic, keep-k); the data stream is a pure function of
    the step, so a resumed run sees the batches the uninterrupted one saw;
  * step retry: a step that raises is retried from the live state (the
    train step updates nothing in place) up to ``max_retries`` times, then
    the last checkpoint is restored (a rollback) and the steps after it run
    again; with no checkpoint, or when the steps fail again before one has
    succeeded since the last rollback, the error is raised.  (The reference
    counts the restored state as the failed step's result and logs the
    step before's metrics for it.);
  * emergency save on SIGTERM/SIGINT: the step in flight finishes, the
    state is saved and the loop returns;
  * straggler watch: steps slower than ``straggler_factor`` x the median of
    the last 50 are recorded with their times.

A step ends in ``torch.cuda.synchronize`` on the card (the reference's
``block_until_ready``), so an asynchronous kernel failure surfaces inside
the step's retry and every step time covers its device work.
``LoopState`` counts the retries and rollbacks; ``train`` returns it when
asked.  The reference's elastic ``remesh`` waits for training across
processes (ROADMAP Queue 1 item 16g) and raises.
"""

from __future__ import annotations

import collections
import logging
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.train.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt_dir: str = "repro_torch_ckpt"
    keep: int = 3
    max_retries: int = 2
    straggler_factor: float = 2.0
    log_every: int = 10


@dataclass
class LoopState:
    step: int = 0
    step_times: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=50))
    stragglers: list = field(default_factory=list)
    interrupted: bool = False
    retries: int = 0       # failed attempts retried from the live state
    rollbacks: int = 0     # restores of the last checkpoint after retries ran out
    resumed_from: Optional[int] = None


def _sync(tree) -> None:
    """Wait for the card's work on ``tree``'s tensors (nothing on the CPU)."""
    devs = {v.device for v in tree.values() if isinstance(v, torch.Tensor)}
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def train(step_fn: Callable, params: dict, opt_state, data, cfg: LoopConfig,
          *, hooks: Optional[list[Callable]] = None,
          return_state: bool = False):
    """Run the loop; returns (params, opt_state, history), and the
    ``LoopState`` after them with ``return_state=True``."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    state = LoopState()
    history: list[dict[str, Any]] = []

    last = mgr.latest_step()
    if last is not None:
        (params, opt_state), _ = mgr.restore((params, opt_state), last)
        state.step = state.resumed_from = last
        log.info("resumed from step %d", last)

    def _on_signal(signum, frame):
        state.interrupted = True
        log.warning("signal %s: emergency checkpoint after this step", signum)

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread
            pass

    stuck = False          # rolled back, and no step has succeeded since
    try:
        while state.step < cfg.total_steps and not state.interrupted:
            batch = data.batch(state.step)
            t0 = time.perf_counter()
            for attempt in range(cfg.max_retries + 1):
                try:
                    new_params, new_opt, metrics = step_fn(params, opt_state,
                                                           batch)
                    _sync(new_params)
                    params, opt_state = new_params, new_opt
                    stuck = False
                    break
                except Exception as e:  # a transient failure: retry
                    log.warning("step %d attempt %d failed: %r",
                                state.step, attempt, e)
                    if attempt == cfg.max_retries:
                        mgr.wait()
                        last = mgr.latest_step()
                        if last is None or stuck:
                            raise
                        (params, opt_state), _ = mgr.restore(
                            (params, opt_state), last)
                        state.step = last
                        state.rollbacks += 1
                        stuck = True
                        log.error("rolled back to checkpoint step %d", last)
                        metrics = None
                        break
                    state.retries += 1
            dt = time.perf_counter() - t0
            if metrics is None:       # rolled back: the step is run again
                continue

            if len(state.step_times) >= 10:
                med = float(np.median(state.step_times))
                if dt > cfg.straggler_factor * med:
                    state.stragglers.append((state.step, dt, med))
                    log.warning("straggler: step %d took %.3fs (median %.3fs)",
                                state.step, dt, med)
            state.step_times.append(dt)

            state.step += 1
            row = {"step": state.step, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]), "dt": dt}
            history.append(row)
            if state.step % cfg.log_every == 0:
                log.info("step %(step)d loss %(loss).4f %(dt).3fs", row)
            for h in hooks or ():
                h(state.step, params, row)
            if state.step % cfg.ckpt_every == 0:
                mgr.save(state.step, (params, opt_state))

        mgr.save(state.step, (params, opt_state), blocking=True)
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        mgr.close()
    if return_state:
        return params, opt_state, history, state
    return params, opt_state, history


def remesh(params, specs_fn, new_devices=None):
    """The reference's elastic re-scale onto the surviving devices: not
    ported (training across processes, ROADMAP Queue 1 item 16g)."""
    raise NotImplementedError("remesh: training across processes (ROADMAP "
                              "Queue 1 item 16g) is not ported yet")
