"""Run one function on every rank of a ``torch.distributed`` world of local
processes.

    outs = run_world("pkg.module:function", world_size, kwargs={...},
                     backend="gloo")

starts ``world_size`` Python processes (``python -m
repro_torch.launch.world``), each of which joins a process group through a
``FileStore`` in a temporary directory (no network address is needed),
calls ``function(rank, world_size, device, **kwargs)`` and saves what it
returns; ``run_world`` returns those values in rank order, tensors on the
CPU.  Each process sees the parent's ``sys.path``, so ``function`` may live
in any module the parent can import.  ``device`` is where a rank's tensors
go: the card unless the caller passes ``device="cpu"`` (rank r on card ``r %
device_count``; with ``gloo`` and one card every rank shares it).  Each rank
runs one intra-op thread.

A world that does not finish in ``timeout`` seconds, or one of whose ranks
fails, is killed whole, and ``run_world`` raises with the failed ranks'
error output: a deadlocked collective fails its caller instead of hanging
it.  The backend is the caller's choice (``check_backend`` refuses more
NCCL ranks than cards).
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import check_backend


def _rank_device(rank: int, device: str) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank % device_count``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def run_world(target: str, world_size: int, *, kwargs: dict | None = None,
              backend: str = "gloo", device=None,
              timeout: float = 120.0) -> list:
    """Run ``target`` ("module:function") on ``world_size`` ranks and return
    each rank's result (see the module docstring).  ``kwargs`` and the
    results cross through ``torch.save``.  ``device`` ``None`` means CUDA
    and raises without a card."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    check_backend(backend, world_size)
    device = resolve_device(device).type
    tmp = Path(tempfile.mkdtemp(prefix="repro-torch-world-"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        torch.save(dict(kwargs or {}), tmp / "kwargs.pt")
        for rank in range(world_size):
            err = open(tmp / f"rank{rank}.err", "w")
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.world", target,
                     str(rank), str(world_size), str(tmp), backend, device,
                     str(timeout)],
                    env=env, stdout=err, stderr=subprocess.STDOUT))
            finally:
                err.close()
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
        if any(c != 0 for c in codes):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            logs = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + (tmp / f"rank{r}.err").read_text()[-3000:]
                for r, c in enumerate(codes) if c != 0)
            what = ("timed out after {:.0f} s".format(timeout)
                    if None in codes else "failed")
            raise RuntimeError(f"world of {world_size} ranks running "
                               f"{target} {what}:\n{logs}")
        return [torch.load(tmp / f"out{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world_size)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(argv: list[str]) -> None:
    target, rank, world, tmp, backend, device, timeout = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        kwargs = torch.load(tmp / "kwargs.pt", weights_only=False)
        out = fn(rank, world, dev, **kwargs)
        torch.save(out, tmp / f"out{rank}.pt.tmp")
        os.replace(tmp / f"out{rank}.pt.tmp", tmp / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
