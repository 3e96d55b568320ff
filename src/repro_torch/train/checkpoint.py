"""Fault-tolerant training checkpoints: atomic, asynchronous, keep-k (port
of ``repro/train/checkpoint.py``).

Layout, the reference's: ``<dir>/step_<N>/`` with one ``.npy`` per flat key
(``a/b/c`` saved as ``a__b__c.npy``) and ``manifest.json`` (step, keys,
shapes, dtypes, wall time).  Trees are nested dicts, tuples and lists
(named tuples included) of tensors or arrays; None leaves are skipped.  So a
checkpoint written by either package restores in the other.

  * atomic: a save writes ``step_<N>.tmp/`` and moves it into place
    (``_atomic_io.atomic_write_dir``), so a crash mid-save never corrupts
    the latest checkpoint;
  * asynchronous: ``save`` copies the tensors to host memory and returns;
    a writer thread writes them (``_atomic_io.AsyncWriter``), ``wait``
    joins it and raises what it raised;
  * keep-k: older steps are deleted after a successful save.

``restore`` places each leaf on its template leaf's device with the strides
it was saved with: the bases ``torch.linalg.qr`` returns are column-major,
and cuBLAS picks its algorithm, so its bits, by layout.  The reference's
restore onto another mesh (``mesh=``, ``specs=``) waits for training
across processes (ROADMAP Queue 1 item 16g).
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._atomic_io import AsyncWriter, atomic_write_dir


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _host(x) -> np.ndarray:
    """A host copy of a tensor or array (strides kept), which the caller
    may go on changing while the writer thread writes it."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.cpu() if x.device.type != "cpu" else x.clone()).numpy()
    return np.array(x)


def _file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer = AsyncWriter(name="repro-torch-train-ckpt")

    # -- public API ---------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Copy ``tree`` to host memory and queue its write."""
        flat = {k: _host(v) for k, v in _flatten(tree).items()}
        self._writer.submit(lambda: self._write(step, flat))
        if blocking:
            self.wait()

    def wait(self) -> None:
        self._writer.wait()

    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if p.is_dir() and not p.name.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, template, step: Optional[int] = None):
        """``(tree, step)``: the checkpoint of ``step`` (the latest by
        default) in the structure of ``template``, each leaf a tensor with
        the saved dtype, shape and strides on the device of the template's
        leaf (the CPU for a non-tensor leaf)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        if manifest["step"] != step:
            raise ValueError(f"{d}: manifest names step {manifest['step']}")

        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                items = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
                return (type(tree)(*items) if hasattr(tree, "_fields")
                        else type(tree)(items))
            if tree is None:
                return None
            arr = np.load(d / _file(prefix[:-1]))
            dev = tree.device if isinstance(tree, torch.Tensor) else "cpu"
            return torch.from_numpy(np.array(arr)).to(dev)

        return rebuild(template), step

    def close(self) -> None:
        self.wait()

    # -- writer-thread body --------------------------------------------------

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": {k: [list(v.shape), str(v.dtype)]
                     for k, v in flat.items()},
        }

        def write_arrays(tmp: Path) -> None:
            for k, v in flat.items():
                np.save(tmp / _file(k), v)

        atomic_write_dir(self.dir / f"step_{step}", write_arrays,
                         manifest=manifest)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*") if p.is_dir()
                       and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
