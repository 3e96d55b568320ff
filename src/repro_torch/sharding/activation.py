"""The active mesh and the collectives of the model's mesh branches (port of
``repro/sharding/activation.py``).

The mesh is process-global state, as in the reference: the launcher (or a
test's rank) calls ``set_mesh`` with a bound ``launch.mesh.HostMesh`` and
``set_param_specs`` with the layout of the params the steps are given; the
model code reads them.  There is one process a device, so a rank holds its
own slice of every leaf and its own rows of the batch.

The reference's ``constrain`` and ``pin_param`` only tell XLA where to put
a value; on a rank's local tensors they are the identity.  Where XLA's
partitioner inserts a collective, the port calls one explicitly, over the
``HostMesh`` group of the axis, as an ``autograd.Function``:

  * ``psum``: all-reduce; the backward passes the cotangent through (the
    sum's consumers, the same on every rank of the axis, each count once);
  * ``enter``: the identity; the backward all-reduces (a value the same on
    every rank goes into work split over the axis: each rank's cotangent
    is its part's);
  * ``all_gather``: the backward keeps this rank's chunk.

The ZeRO gather of a stored leaf at use (``gather_leaf``) is not
differentiated: the train step gathers its compute copies under
``torch.no_grad`` and maps each copy's gradient back to the stored slice
with ``reduce_grad`` (``models.registry.loss_and_grads``), which sums over
the batch axes (their ranks hold other rows) and keeps this rank's chunk
over ``model`` (whose ranks compute the same rows alike).

The reference's ``tp`` flag chooses where XLA splits the heads and MLP;
the port gathers those weights either way and computes them alike on
every rank of the model axis, so ``set_mesh`` takes no such flag.

Sums run in the tensor's dtype: gloo all-reduces bf16 tensors, on the CPU
and on the card, as XLA's psum adds bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE: dict = {"mesh": None, "param_specs": None, "global_batch": None}

# the reference's logical "batch" axis, filtered to the axes the mesh has
BATCH_AXES = ("pod", "data")


def set_mesh(mesh) -> None:
    """Make ``mesh`` (a bound ``HostMesh``, or None) the active mesh."""
    _ACTIVE["mesh"] = mesh


def get_mesh():
    return _ACTIVE["mesh"]


def set_param_specs(specs: Optional[dict]) -> None:
    """Register the spec of each param as the steps receive it (the
    reference pins its bf16 compute copies to these); None means
    ``rules.param_specs(cfg, mesh)``, the training layout."""
    _ACTIVE["param_specs"] = specs


def get_param_specs() -> Optional[dict]:
    return _ACTIVE["param_specs"]


def pin_param(key: str, x: torch.Tensor) -> torch.Tensor:
    """The identity: the reference's layout hint for XLA."""
    return x


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The identity: the reference's layout hint for XLA (a rank's tensor
    is already its own block)."""
    return x


# ---------------------------------------------------------------------------
# Rows of the batch
# ---------------------------------------------------------------------------

def batch_split(mesh, n: int):
    """The batch axes a global batch of ``n`` rows is split over, or None
    where they do not divide it (then every rank takes every row, as the
    reference's ``_batch_axes`` replicates long_500k's batch of 1)."""
    ba = batch_axes_of(mesh)
    if not ba or n % mesh.size(ba):
        return None
    return ba


def local_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (dim 0)."""
    ba = batch_split(mesh, x.shape[0])
    if ba is None:
        return x
    k = x.shape[0] // mesh.size(ba)
    return x[mesh.index(ba) * k:(mesh.index(ba) + 1) * k]


def global_rows(mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``local_rows`` for a global batch of ``n``: gathers
    the rows over the batch axes (not differentiable)."""
    ba = batch_split(mesh, n)
    return x if ba is None else gather(x, 0, mesh, ba)


class global_batch:
    """``with global_batch(n):`` tells the routed experts the global batch
    of the forward running inside (their capacity counts it)."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        self.old, _ACTIVE["global_batch"] = _ACTIVE["global_batch"], self.n

    def __exit__(self, *exc):
        _ACTIVE["global_batch"] = self.old


def get_global_batch() -> Optional[int]:
    return _ACTIVE["global_batch"]


# ---------------------------------------------------------------------------
# Collectives (not differentiable)
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` over ``axes``, chunks in
    row-major order over the axes (the reference's tiling)."""
    if mesh.size(axes) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, x, group=mesh.group(axes))
    chunks = [None] * len(parts)
    for part, i in zip(parts, mesh.group_order(axes)):
        chunks[i] = part
    return torch.cat(chunks, dim=dim)


def chunk(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``axes``."""
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axes} of {n}")
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * k, k)


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``axes`` (a new tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    if mesh.size(axes) > 1:
        dist.all_reduce(x, group=mesh.group(axes))
    return x


def _spec_axes(entry) -> tuple:
    return () if entry is None else _axes(entry)


def batch_axes_of(mesh) -> tuple:
    """The mesh's axes whose ranks hold other rows of the batch."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def whole_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape from a rank's slice's ``shape``."""
    return tuple(n * (1 if e is None else mesh.size(e))
                 for n, e in zip(shape, spec))


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole of a leaf stored as ``spec`` (one entry a dim: an axis, a
    tuple of axes or None)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = gather(x, dim, mesh, entry)
    return x


def slice_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf ``x`` stored as ``spec`` (a
    view)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = chunk(x, dim, mesh, entry)
    return x


def shard_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``slice_leaf`` as a contiguous copy, so ``x`` may be freed."""
    return slice_leaf(x, spec, mesh).clone(memory_format=torch.contiguous_format)


def reduce_grad(g: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The transpose of ``gather_leaf`` for a gradient of the whole leaf:
    over ``model`` it keeps this rank's chunk (its ranks computed the same
    gradient), first, so that less is summed; a dim split over batch axes
    then sums over them (their ranks saw other rows) and keeps the
    chunk."""
    ba = set(batch_axes_of(mesh))
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if axes and not set(axes) & ba:
            g = chunk(g, dim, mesh, axes)
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        summed = tuple(a for a in axes if a in ba)
        if summed:
            g = chunk(all_reduce(g, mesh, summed), dim, mesh, axes)
    return g.contiguous()


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.dim, ctx.mesh, ctx.axes), None, None, None


def _trivial(mesh, axes) -> bool:
    return mesh is None or mesh.size(axes) == 1


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """All-reduce over ``axes``; the backward is the identity."""
    mesh = mesh or get_mesh()
    return x if _trivial(mesh, axes) else _Psum.apply(x, mesh, axes)


def enter(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The identity; the backward all-reduces over ``axes``."""
    mesh = mesh or get_mesh()
    return x if _trivial(mesh, axes) else _Enter.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """Concatenate over ``axes`` along ``dim``; the backward keeps this
    rank's chunk."""
    mesh = mesh or get_mesh()
    return x if _trivial(mesh, axes) else _AllGather.apply(x, dim, mesh, axes)


def split_axes(spec) -> set:
    """The mesh axes a leaf stored as ``spec`` is split over."""
    return {a for e in spec for a in _spec_axes(e)}
