"""Host meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``:
``make_host_mesh``, ``make_production_mesh`` and the roofline constants).

A :class:`HostMesh` names its axes (``("data", "model")`` by default) and
their sizes.  Unbound, it is names and sizes only: what the single-controller
streamed driver (``core.distributed.distributed_rsvd_streamed``) takes, as
the reference's runs on one controller, and what ``sharding.rules`` derives
its specs from.  ``bind()`` binds it to the current ``torch.distributed``
world, or with ``ranks=`` to some of its ranks (``train.loop.remesh``'s
survivors): one process group per line of every set of axes, with ranks in
``jax.make_mesh``'s order (row-major over the axes: on a (data, model)
mesh, rank = data_index * model_size + model_index).  A bound mesh gives
each of its ranks its ``index(axis)`` and the ``group(axis)`` its
collectives over that axis (or tuple of axes, the ``("data", "model")`` of
a leaf sharded over both) run in.

The caller chooses the backend when it starts the world (``gloo`` or
``nccl``); nothing here switches one for the other.  NCCL puts one rank on
one card, so a world of more NCCL ranks than cards is refused
(:func:`check_backend`).

``make_production_mesh`` gives the reference's production cells, unbound:
(16, 16) over ("data", "model") and, for the multi-pod dry run, (2, 16, 16)
over ("pod", "data", "model").  The dry run (``launch/dryrun.py``) binds
one to a fake world of its size.  The roofline constants below are one
H100 SXM's (NVIDIA's data sheet), not the reference's TPU v5e's.
"""

from __future__ import annotations

import itertools
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
        self._ranks: list[int] | None = None   # the world ranks, once bound
        self._rank: int | None = None           # this process's mesh rank
        self._groups: dict[frozenset, object] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes)

    @property
    def bound(self) -> bool:
        return self._ranks is not None

    @property
    def member(self) -> bool:
        """Bound, and this process is one of the mesh's ranks."""
        return self._rank is not None

    @property
    def ranks(self) -> list[int]:
        """The world ranks of mesh ranks 0, 1, ... (bound meshes)."""
        self._need_bound()
        return list(self._ranks)

    def __repr__(self) -> str:
        state = (f"rank {self._rank}" if self.member else
                 "not a member" if self.bound else "unbound")
        return f"HostMesh({self.shape}, {state})"

    def _axis(self, axis: str) -> int:
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}") from None

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            self._axis(a)
        return axes

    def size(self, axes) -> int:
        """The length of an axis, or the product over a tuple of axes."""
        return math.prod(self.sizes[self._axis(a)] for a in self._axes(axes))

    def coords(self, rank: int) -> tuple[int, ...]:
        """The mesh coordinates of ``rank`` (row-major over the axes)."""
        return tuple(int(c) for c in np.unravel_index(rank, self.sizes))

    def lines(self, axes) -> list[list[int]]:
        """The mesh ranks of each line along ``axes`` (an axis or a tuple),
        every other coordinate fixed, lines in row-major order of the other
        axes and ranks within a line row-major over ``axes`` in their
        order."""
        idx = [self._axis(a) for a in self._axes(axes)]
        ranks = np.arange(self.world_size).reshape(self.sizes)
        moved = np.moveaxis(ranks, idx, list(range(-len(idx), 0)))
        return moved.reshape(-1, self.size(axes)).tolist()

    def bind(self, ranks=None) -> "HostMesh":
        """Bind to the current ``torch.distributed`` world: mesh rank i is
        world rank ``ranks[i]`` (all of the world's ranks in order by
        default; their number must be the mesh's).  Every rank of the
        world calls this, in one order with the other ranks
        (``new_group`` is collective), also one outside ``ranks``, which
        gets a bound mesh it is not a ``member`` of; each member keeps the
        group of its line along every set of axes."""
        if not dist.is_initialized():
            raise RuntimeError("bind() needs torch.distributed initialized "
                               "(init_process_group) on every rank")
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != self.world_size:
            raise ValueError(f"mesh {self.shape} holds {self.world_size} "
                             f"ranks, given {len(ranks)} of a world of "
                             f"{world}")
        if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                    for r in ranks):
            raise ValueError(f"ranks {ranks} are not distinct ranks of a "
                             f"world of {world}")
        check_backend(dist.get_backend(), world)
        me = dist.get_rank()
        rank = ranks.index(me) if me in ranks else None
        groups = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                for line in self.lines(axes):
                    group = dist.new_group([ranks[r] for r in line])
                    if rank in line:
                        groups[frozenset(axes)] = group
        self._ranks, self._rank, self._groups = ranks, rank, groups
        return self

    def _need_bound(self) -> None:
        if not self.bound:
            raise RuntimeError(f"{self!r} is not bound to a world: call "
                               f"bind() on every rank first")

    def _need_member(self) -> None:
        self._need_bound()
        if not self.member:
            raise RuntimeError(f"{self!r}: this process is not one of its "
                               f"ranks")

    def _index_of(self, mesh_rank: int, axes) -> int:
        c, out = self.coords(mesh_rank), 0
        for a in self._axes(axes):
            i = self._axis(a)
            out = out * self.sizes[i] + c[i]
        return out

    def index(self, axes) -> int:
        """This rank's coordinate along an axis, or its row-major index
        over a tuple of axes."""
        self._need_member()
        return self._index_of(self._rank, axes)

    def group(self, axes):
        """The process group of this rank's line along ``axes`` (an axis
        or a tuple).  Its ranks are numbered in world-rank order, which
        is row-major over the mesh's axes: over a tuple given out of the
        mesh's order, reorder what it gathers (``sharding.activation``)."""
        self._need_member()
        return self._groups[frozenset(self._axes(axes))]

    def group_order(self, axes) -> list[int]:
        """The index over ``axes`` (as ``index`` gives it) of each rank of
        ``group(axes)``, in the group's own order (world ranks sorted)."""
        self._need_member()
        line = next(l for l in self.lines(axes) if self._rank in l)
        return [self._index_of(r, axes)
                for r in sorted(line, key=lambda r: self._ranks[r])]

    def world_rank(self, mesh_rank: int) -> int:
        self._need_bound()
        return self._ranks[mesh_rank]


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The reference's production mesh as an unbound ``HostMesh``: 256
    ranks as (data 16, model 16), or 512 as (pod 2, data 16, model 16)."""
    if multi_pod:
        return HostMesh((2, 16, 16), ("pod", "data", "model"))
    return HostMesh((16, 16), ("data", "model"))


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


# Hardware constants for the roofline model: one NVIDIA H100 SXM (NVIDIA's
# data sheet, dense rates, at the full 700 W power limit; a card set below
# it, as nvidia-smi's power.limit shows, runs slower under load).
PEAK_BF16_FLOPS = 989e12      # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12              # B/s, device memory
NVLINK_BW = 450e9             # B/s each way to the other cards of the host
HBM_BYTES = 80e9              # 80 GB of device memory
