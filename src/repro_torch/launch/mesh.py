"""Host meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``:
``make_host_mesh``).

A :class:`HostMesh` names its axes (``("data", "model")`` by default) and
their sizes.  Unbound, it is names and sizes only: what the single-controller
streamed driver (``core.distributed.distributed_rsvd_streamed``) takes, as
the reference's runs on one controller.  ``bind()`` binds it to the current
``torch.distributed`` world: one process group per line of each axis, with
ranks in ``jax.make_mesh``'s order (row-major over the axes: on a
(data, model) mesh, rank = data_index * model_size + model_index).  A bound
mesh gives each rank its ``index(axis)`` and the ``group(axis)`` its
collectives over that axis run in.

The caller chooses the backend when it starts the world (``gloo`` or
``nccl``); nothing here switches one for the other.  NCCL puts one rank on
one card, so a world of more NCCL ranks than cards is refused
(:func:`check_backend`).  ``make_production_mesh`` waits for the training
slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist


def check_backend(backend: str, world_size: int) -> None:
    """Raise where ``backend`` cannot hold ``world_size`` ranks on this
    machine: NCCL takes one card a rank (two ranks on one card are refused
    by NCCL), so more NCCL ranks than cards fail here, before any rank
    starts."""
    if str(backend).lower() == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > cards:
            raise RuntimeError(
                f"nccl needs one CUDA card a rank: {world_size} ranks, "
                f"{cards} cards; run the world with backend='gloo' (which "
                f"takes CUDA tensors too) or on more cards")


class HostMesh:
    """Named axes of a process world.  ``sizes[i]`` is the length of axis
    ``axis_names[i]``; the product is the world size."""

    def __init__(self, sizes, axis_names=("data", "model")):
        sizes = tuple(int(s) for s in sizes)
        axis_names = tuple(str(a) for a in axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh sizes {sizes} do not match the distinct "
                             f"axis names {axis_names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        self.sizes = sizes
        self.axis_names = axis_names
        self._rank: int | None = None
        self._groups: dict[str, object] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes)

    @property
    def bound(self) -> bool:
        return self._rank is not None

    def __repr__(self) -> str:
        state = f"rank {self._rank}" if self.bound else "unbound"
        return f"HostMesh({self.shape}, {state})"

    def _axis(self, axis: str) -> int:
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}") from None

    def size(self, axis: str) -> int:
        return self.sizes[self._axis(axis)]

    def coords(self, rank: int) -> tuple[int, ...]:
        """The mesh coordinates of ``rank`` (row-major over the axes)."""
        return tuple(int(c) for c in np.unravel_index(rank, self.sizes))

    def lines(self, axis: str) -> list[list[int]]:
        """The ranks of each line along ``axis``, every other coordinate
        fixed, lines in row-major order of the other axes."""
        ranks = np.arange(self.world_size).reshape(self.sizes)
        moved = np.moveaxis(ranks, self._axis(axis), -1)
        return moved.reshape(-1, self.size(axis)).tolist()

    def bind(self) -> "HostMesh":
        """Bind to the current ``torch.distributed`` world, whose size must
        be the mesh's: every rank creates the group of every line of every
        axis, in one order (``new_group`` is collective), and keeps its
        own."""
        if not dist.is_initialized():
            raise RuntimeError("bind() needs torch.distributed initialized "
                               "(init_process_group) on every rank")
        world = dist.get_world_size()
        if world != self.world_size:
            raise ValueError(f"mesh {self.shape} holds {self.world_size} "
                             f"ranks, the world has {world}")
        check_backend(dist.get_backend(), world)
        rank = dist.get_rank()
        groups = {}
        for axis in self.axis_names:
            for line in self.lines(axis):
                group = dist.new_group(line)
                if rank in line:
                    groups[axis] = group
        self._rank, self._groups = rank, groups
        return self

    def _need_bound(self) -> None:
        if not self.bound:
            raise RuntimeError(f"{self!r} is not bound to a world: call "
                               f"bind() on every rank first")

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        self._need_bound()
        return self.coords(self._rank)[self._axis(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._need_bound()
        self._axis(axis)
        return self._groups[axis]


def make_host_mesh(model_parallel: int = 1) -> HostMesh:
    """A (data, model) mesh over the current world (bound), or over one
    process where no world is initialized (unbound, 1 x 1).  A
    ``model_parallel`` that does not divide the world falls back to 1, as
    the reference's does."""
    if not dist.is_initialized():
        return HostMesh((1, 1))
    n = dist.get_world_size()
    if n % model_parallel:
        model_parallel = 1
    return HostMesh((n // model_parallel, model_parallel)).bind()
