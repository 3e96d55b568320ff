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
and cuBLAS picks its algorithm, so its bits, by layout.

Across processes: a manager made with a bound ``mesh`` (``launch.mesh.
HostMesh``) is collective.  ``save(..., specs=)`` (``specs`` is a tree like
the saved one, a spec for each tensor) puts each leaf together on mesh
rank 0's host, one leaf at a time: every rank sends its slice to rank 0
(``dist.gather``), so no rank holds more of the tree on its device than its
own slices, and rank 0 alone writes the reference's layout while the
others wait at a barrier; ``latest_step`` is rank 0's answer on every
rank.  ``restore(...,
mesh=, specs=)``, as the reference's, gives each rank its slice of each
leaf (read memory-mapped) for any mesh, so a world's checkpoint restores
in one process, in another world or in the reference, and the reverse.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._atomic_io import AsyncWriter, atomic_write_dir
from repro_torch.sharding import activation as A


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


def _flatten_specs(tree, specs, prefix: str = "") -> dict[str, tuple]:
    """The spec of each leaf ``_flatten(tree)`` yields, read from a spec
    tree of the same structure (its leaves are spec tuples)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_specs(v, specs[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten_specs(v, specs[i], f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tuple(specs)
    return out


def _block(shape, spec, mesh, mesh_rank: int) -> tuple:
    """The index of mesh rank ``mesh_rank``'s block of a whole array of
    ``shape`` stored as ``spec`` (chunks row-major over an entry's axes,
    the reference's tiling)."""
    coords = dict(zip(mesh.axis_names, mesh.coords(mesh_rank)))
    index = []
    for n, entry in zip(shape, spec):
        if entry is None:
            index.append(slice(None))
            continue
        i = 0
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = i * mesh.size(a) + coords[a]
        k = n // mesh.size(entry)
        index.append(slice(i * k, (i + 1) * k))
    return tuple(index)


def _mesh_rank(mesh) -> int:
    return mesh.index(mesh.axis_names)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3, *, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh
        self.writes = mesh is None or _mesh_rank(mesh) == 0
        if self.writes:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer = AsyncWriter(name="repro-torch-train-ckpt")

    # -- public API ---------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False, *,
             specs=None) -> None:
        """Copy ``tree`` to host memory and queue its write.  With a mesh:
        collective, each leaf put together whole on mesh rank 0's host by
        its spec in ``specs``."""
        flat = _flatten(tree)
        if self.mesh is not None:
            specs = _flatten_specs(tree, specs) if specs is not None else {}
            host = {k: self._to_root(v, specs.get(k, ()))
                    for k, v in sorted(flat.items())}
        elif self.writes:
            host = {k: _host(v) for k, v in flat.items()}
        del flat
        if self.writes:
            self._writer.submit(lambda: self._write(step, host))
            if blocking:
                self.wait()
        self._barrier()

    def _to_root(self, x, spec):
        """The whole of a leaf stored as ``spec`` (``x`` is this rank's
        slice) as a host array on mesh rank 0, None on the other ranks.
        Every rank sends its slice once; gloo takes it from the host, NCCL
        from the card."""
        mesh = self.mesh
        if not isinstance(x, torch.Tensor) or not A.split_axes(spec):
            return _host(x) if self.writes else None
        axes = mesh.axis_names
        group = mesh.group(axes)
        x = x.detach()
        send = (x if dist.get_backend(group) == "nccl" else x.cpu()).contiguous()
        parts = ([torch.empty_like(send) for _ in range(mesh.size(axes))]
                 if self.writes else None)
        dist.gather(send, parts, dst=mesh.world_rank(0), group=group)
        if not self.writes:
            return None
        shape = A.whole_shape(x.shape, spec, mesh)
        whole = torch.empty(shape, dtype=x.dtype)
        for part, r in zip(parts, mesh.group_order(axes)):
            whole[_block(shape, spec, mesh, r)] = part
        return whole.numpy()

    def wait(self) -> None:
        self._writer.wait()

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))

    def latest_step(self) -> Optional[int]:
        """The newest complete step; with a mesh, rank 0's (its writes
        finished first), the same on every rank."""
        step = None
        if self.writes:
            if self.mesh is not None:
                self.wait()
            steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                     if p.is_dir() and not p.name.endswith(".tmp")]
            step = max(steps) if steps else None
        if self.mesh is not None:
            box = [step]
            dist.broadcast_object_list(
                box, src=self.mesh.world_rank(0),
                group=self.mesh.group(self.mesh.axis_names))
            step = box[0]
        return step

    def restore(self, template, step: Optional[int] = None, mesh=None,
                specs=None):
        """``(tree, step)``: the checkpoint of ``step`` (the latest by
        default) in the structure of ``template``, each leaf a tensor with
        the saved dtype, shape and strides on the device of the template's
        leaf (the CPU for a non-tensor leaf).  With ``mesh`` (bound) and
        ``specs`` (a tree like ``template``), each leaf is this rank's
        slice by its spec."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        if manifest["step"] != step:
            raise ValueError(f"{d}: manifest names step {manifest['step']}")
        flat_spec = (_flatten_specs(template, specs)
                     if mesh is not None and specs is not None else {})

        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                items = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
                return (type(tree)(*items) if hasattr(tree, "_fields")
                        else type(tree)(items))
            if tree is None:
                return None
            key = prefix[:-1]
            arr = np.load(d / _file(key), mmap_mode="r")
            if key in flat_spec:
                arr = arr[_block(arr.shape, flat_spec[key], mesh,
                                 _mesh_rank(mesh))]
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
