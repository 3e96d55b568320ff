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
asked.

Across processes (``train(..., mesh=, specs=)``, a bound ``HostMesh`` and
the spec tree of ``(params, opt_state)``): checkpoints are collective
(``CheckpointManager(mesh=)``), every rank resumes from the step rank 0
finds, and after each attempt the ranks agree whether any of them failed
or was signalled, so a retry, a rollback or an emergency save is taken by
all together.  A rank that fails inside a collective leaves its peers
waiting there; the world's timeout (``launch.world.run_world``, or
``init_process_group``'s) turns that into a failure.  ``remesh`` is the
reference's elastic re-scale onto the surviving ranks.
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
import torch.distributed as dist

from repro_torch.launch.mesh import HostMesh
from repro_torch.sharding import activation as A
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


def _any(mesh, flag: bool, like: torch.Tensor) -> bool:
    """Whether ``flag`` holds on any rank of ``mesh`` (or this one)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=like.device)
    return bool(A.all_reduce(t, mesh, mesh.axis_names).item())


def train(step_fn: Callable, params: dict, opt_state, data, cfg: LoopConfig,
          *, hooks: Optional[list[Callable]] = None,
          return_state: bool = False, mesh=None, specs=None):
    """Run the loop; returns (params, opt_state, history), and the
    ``LoopState`` after them with ``return_state=True``.  Under a ``mesh``
    every rank runs it with its slices and ``specs`` (module docstring)."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep, mesh=mesh)
    state = LoopState()
    history: list[dict[str, Any]] = []
    like = next(iter(params.values()))

    def restore(step):
        return mgr.restore((params, opt_state), step, mesh=mesh,
                           specs=specs)[0]

    last = mgr.latest_step()
    if last is not None:
        params, opt_state = restore(last)
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
                err = None
                try:
                    new_params, new_opt, metrics = step_fn(params, opt_state,
                                                           batch)
                    _sync(new_params)
                except Exception as e:  # a transient failure: retry
                    err = e
                if not _any(mesh, err is not None, like):
                    params, opt_state = new_params, new_opt
                    stuck = False
                    break
                log.warning("step %d attempt %d failed: %r", state.step,
                            attempt, err or "on another rank")
                if attempt == cfg.max_retries:
                    mgr.wait()
                    last = mgr.latest_step()
                    if last is None or stuck:
                        if err is not None:
                            raise err
                        raise RuntimeError(f"step {state.step} failed on "
                                           f"another rank")
                    params, opt_state = restore(last)
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
                mgr.save(state.step, (params, opt_state), specs=specs)
            state.interrupted = _any(mesh, state.interrupted, like)

        mgr.save(state.step, (params, opt_state), blocking=True, specs=specs)
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        mgr.close()
    if return_state:
        return params, opt_state, history, state
    return params, opt_state, history


def remesh(params, specs_fn, new_ranks=None, *, mesh, device=None):
    """Elastic re-scale (the reference's): rebuild a (n, 1) mesh over the
    surviving ranks ``new_ranks`` (all of the world's by default) and
    re-place every leaf by the same logical rules, ``specs_fn(mesh) ->
    {name: spec}``.  ``params`` are this rank's slices on the bound
    ``mesh`` they live on.

    Every rank of the world calls it, those leaving or joining too: the
    members of ``mesh`` gather each leaf; where a new rank held none, the
    old mesh's rank 0 broadcasts it.  Returns ``(new_mesh, placed)``,
    ``placed`` None on a rank outside the new mesh.  ``device`` places a
    joining rank's leaves (default: the device of ``params``; a rank
    outside ``mesh`` holds none and passes it)."""
    world = dist.get_world_size()
    new_ranks = list(range(world)) if new_ranks is None else list(new_ranks)
    old_specs = specs_fn(mesh)
    new = HostMesh((len(new_ranks), 1)).bind(ranks=new_ranks)
    new_specs = specs_fn(new)
    root = mesh.world_rank(0)
    meta = [None]
    if mesh.member and mesh.index(mesh.axis_names) == 0:
        meta = [[(k, A.whole_shape(v.shape, old_specs[k], mesh), v.dtype)
                 for k, v in sorted(params.items())]]
    dist.broadcast_object_list(meta, src=root)
    joining = any(r not in mesh.ranks for r in new_ranks)
    if device is None:
        device = next(iter(params.values())).device
    placed = {}
    for k, shape, dtype in meta[0]:
        whole = (A.gather_leaf(params[k], old_specs[k], mesh)
                 if mesh.member else None)
        if joining:
            if whole is None:
                whole = torch.empty(shape, dtype=dtype, device=device)
            dist.broadcast(whole, src=root)
        if new.member:
            placed[k] = A.shard_leaf(whole, new_specs[k], new)
        del whole
    return new, (placed if new.member else None)
