"""Dry run: every (arch x shape x mesh) cell of the port, run once and
counted (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for 256 or 512
placeholder devices and reads XLA's cost analysis, memory analysis and HLO
text.  Eager PyTorch has no compiled program to read, so the port runs its
own step once, as rank 0 of a fake world that covers the production mesh
(the ``fake`` backend of ``torch.testing._internal.distributed.fake_pg``:
every collective returns at once), on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): nothing is allocated,
no kernel runs and no device is touched.  What rank 0 executes is counted:

  * ``flops``: the matmul FLOPs of ``torch.utils.flop_counter.
    FlopCounterMode`` (matrix products, attention and convolutions; not the
    elementwise work XLA's cost analysis adds);
  * ``bytes``: the operand and result bytes of every aten op that is not a
    view, summed (each op's inputs read once and outputs written once; no
    cache or fusion is modelled);
  * ``collective_bytes``: the result bytes of each ``torch.distributed``
    collective (the ``c10d`` ops), under the reference's five keys.  An
    eager step runs a layer's collectives once a layer, so no trip count
    scales them (``collective_calls`` lists each by op and caller);
  * ``memory``: the bytes of the arguments (rank 0's slices of params,
    optimizer state and inputs at ``sharding.rules``' specs), of the
    outputs, the outputs that are arguments (``alias_bytes``: a cache
    updated in place) and the step's own peak of live bytes less its
    outputs (``temp_bytes``), from a tally of tensor storages.

The port's entry points take the global batch (``forward`` keeps its rows)
and a decode cache whose sequence is whole on the rank (its decode
attention has no sequence-sharded branch), while the rules store the inputs
as each rank's rows and a KV cache's sequence over ``model``.  So the step
first gathers its inputs from the stored slices with the port's own
collective (``activation.gather``, as ``launch.train.GlobalBatches`` gathers
a host's rows), and those gathers are counted.

The step is the one the configs name: the plain attention (no
``use_flash_kernel``), as the reference's dry run lowers it.  It takes no
compile step, so ``compile_s`` and XLA's extra ``cost_analysis`` fields are
null.  The row's ``lower_s`` is the seconds the traced run took.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m \\
        --shape decode_32k --mesh single

Rows go to ``$REPRO_TORCH_DRYRUN_DIR``, else ``results/dryrun_torch/``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._atomic_io import atomic_write_json
from repro_torch.configs.base import ALL_SHAPES, ModelCfg, ShapeCfg, shapes_for
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.sharding import activation as A
from repro_torch.sharding import rules

SHAPES = {s.name: s for s in ALL_SHAPES}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d's ops (what ``torch.distributed``'s calls dispatch to) and the
# functional collectives, by the reference's HLO names; the result is the
# first argument of a c10d op and the output of a functional one.
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute",
         "broadcast_": "broadcast"}
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "broadcast"}

_PACKAGE = os.sep + "repro_torch" + os.sep
_ACTIVATION = os.path.join("sharding", "activation.py")


def results_dir() -> Path:
    return Path(os.environ.get(
        "REPRO_TORCH_DRYRUN_DIR",
        Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _caller() -> str:
    """The innermost frame of the package outside ``sharding/activation.py``
    (else the innermost of the package) and outside this module: where a
    collective was asked for."""
    first = None
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if _PACKAGE in path and path != __file__:
            where = (f"{path.rsplit(_PACKAGE, 1)[1]}:{f.f_lineno} "
                     f"{f.f_code.co_name}")
            if not path.endswith(_ACTIVATION):
                return where
            first = first or where
        f = f.f_back
    return first or "?"


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives run inside it: result bytes by kind (the
    reference's five keys; a broadcast goes to ``other``) and each call's
    op, caller and bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.other: dict[str, int] = {}
        self.calls: list[tuple[str, str, str, int]] = []

    def count(self, func, args, out) -> None:
        ns = func.namespace
        if ns not in ("c10d", "_c10d_functional"):
            return
        name = func._schema.name.split("::")[-1]
        kind = (_C10D if ns == "c10d" else _FUNCTIONAL).get(name)
        if kind is None:
            return
        n = _nbytes(args[0] if ns == "c10d" else out)
        if kind in self.bytes:
            self.bytes[kind] += n
        else:
            self.other[kind] = self.other.get(kind, 0) + n
        self.calls.append((kind, f"{ns}::{name}", _caller(), n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(func, args, out)
        return out

    def grouped(self) -> list[dict]:
        """The calls grouped by (kind, op, caller, bytes a call), the
        largest total first."""
        counts = Counter(self.calls)
        rows = [{"kind": k, "op": op, "caller": c, "bytes": n, "calls": m,
                 "total_bytes": n * m}
                for (k, op, c, n), m in counts.items()]
        return sorted(rows, key=lambda r: -r["total_bytes"])


class StepCounter(CollectiveCounter):
    """The collectives, and besides (in the same pass over each op): the
    bytes of every aten op's operands and results (views excluded), and a
    tally of the live bytes of the storages made inside it: each new
    storage adds its bytes and its release (a weak reference's callback)
    takes them off.  ``track`` registers storages made before (the
    arguments), which are not the step's own."""

    def __init__(self):
        super().__init__()
        x = torch.empty(0)
        if x.untyped_storage() is not x.untyped_storage():
            raise RuntimeError("this torch does not keep one Python object a "
                               "storage, which the live-byte tally needs")
        self.op_bytes = 0
        self.live = self.peak = 0
        self._refs: dict[int, weakref.ref] = {}
        self._sizes: dict[int, int] = {}

    def _release(self, key, ref):
        if self._refs.get(key) is ref:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    @staticmethod
    def storages(x):
        """The distinct storages of the tensors in ``x``."""
        seen = {}
        for t in _tensors(x):
            st = t.untyped_storage()
            seen.setdefault(id(st), st)
        return list(seen.values())

    def track(self, x) -> None:
        for st in self.storages(x):
            self._refs.setdefault(id(st), weakref.ref(st))

    def owns(self, st) -> bool:
        """``st`` was made inside and is alive."""
        ref = self._refs.get(id(st))
        return ref is not None and ref() is st and id(st) in self._sizes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(func, args, out)
        if func.namespace == "aten" and not func.is_view:
            self.op_bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            ref = self._refs.get(key)
            if ref is not None and ref() is st:
                continue
            self._refs[key] = weakref.ref(st, lambda r, key=key:
                                          self._release(key, r))
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        return out


def _distinct_bytes(tree) -> int:
    return sum(st.nbytes() for st in StepCounter.storages(tree))


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a world of ``size`` on the ``fake``
    backend (its collectives do nothing); destroyed on exit.  Refuses to
    start inside an initialized world."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world: this "
                           "process already has a torch.distributed world")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree of the same shape."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    if tree is None:
        return None
    return fn(tree, specs)


def _step_inputs(cfg: ModelCfg, shape: ShapeCfg, mesh: HostMesh, stored,
                 specs) -> dict:
    """The batch the port's step takes, from the stored slices: ids and
    embeddings gathered into the global batch over the batch axes, a
    cache's other split dims gathered (the rank keeps its rows),
    ``write_pos`` as a Python int."""
    batch = {}
    for key, leaf in stored.items():
        if key == "write_pos":
            batch[key] = shape.seq_len - 1
        elif key == "cache":
            batch[key] = _map(lambda x, s: _whole_but_rows(x, s, mesh),
                              leaf, specs[key])
        else:
            spec = specs[key]
            batch[key] = (leaf if spec[0] is None
                          else A.gather(leaf, 0, mesh, spec[0]))
    return batch


def _whole_but_rows(x: torch.Tensor, spec, mesh: HostMesh) -> torch.Tensor:
    """Gather every split dim of a cache leaf but its batch dim (the first
    one split over batch axes only)."""
    batch_axes = set(A.batch_axes_of(mesh))
    keep = next((dim for dim, e in enumerate(spec)
                 if e is not None and A.split_axes((e,)) <= batch_axes), None)
    for dim, e in enumerate(spec):
        if e is not None and dim != keep:
            x = A.gather(x, dim, mesh, e)
    return x


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def pick_micro_batches(cfg: ModelCfg, shape: ShapeCfg, mesh: HostMesh) -> int:
    """Gradient-accumulation factor: keep remat'd activations (+ logits)
    under ~4 GiB a device (the reference's arithmetic, unchanged)."""
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    per_dev = max(1, shape.global_batch // dp)
    tp = 16 if rules.tp_enabled(cfg) else 1
    act_bytes_per_seq = 2 * shape.seq_len * cfg.d_model * cfg.n_layers // tp
    logit_bytes_per_seq = 4 * shape.seq_len * cfg.vocab // 16
    per_seq = act_bytes_per_seq + logit_bytes_per_seq
    target = max(1, int(4e9 // max(per_seq, 1)))
    want = max(1, -(-per_dev // target))  # ceil
    return next(m for m in range(want, per_dev + 1) if per_dev % m == 0)


def rank_arguments(cfg: ModelCfg, shape: ShapeCfg, mesh: HostMesh, *,
                   micro_batches: int = 1, device=None) -> tuple[dict, dict]:
    """Rank 0's slices of the cell's arguments at ``sharding.rules``' specs
    (the training or, for prefill and decode, the serving layout): new
    tensors of the slices' shapes and dtypes (``device="meta"``: nothing
    allocated; fake under ``FakeTensorMode``).  ``mesh`` needs only its
    sizes.  Returns ``({"params", "opt_state", "inputs"}, their specs)``;
    a serving cell has no optimizer state (None)."""
    serving = shape.kind != "train"
    meta = {"params": T.abstract_params(cfg),
            "inputs": R.input_specs(cfg, shape), "opt_state": None}
    specs = {"params": rules.param_specs(cfg, mesh, serving=serving),
             "inputs": rules.batch_specs(cfg, shape, mesh, meta["inputs"]),
             "opt_state": None}
    if not serving:
        step = R.make_train_step(cfg, micro_batches=micro_batches)
        meta["opt_state"] = step.init_opt(meta["params"])
        specs["opt_state"] = rules.opt_state_specs(cfg, mesh, meta["opt_state"])

    def slice_of(m: torch.Tensor, spec) -> torch.Tensor:
        spec = tuple(spec) + (None,) * (m.ndim - len(spec))
        shape_ = tuple(n // (1 if e is None else mesh.size(e))
                       for n, e in zip(m.shape, spec))
        return torch.empty(shape_, dtype=m.dtype, device=device)

    args = {k: _map(slice_of, meta[k], specs[k]) for k in meta}
    return args, specs


def flops_probe(cfg: ModelCfg, shape: ShapeCfg, micro_batches: int) -> dict:
    """The matmul FLOPs of the whole, unsharded step at full size (one
    process, no mesh), on fake tensors.  Eager PyTorch runs every layer and
    every time step, so nothing needs unrolling; ``micro_batches`` is not
    used (the reference's probe runs one microbatch too)."""
    if dist.is_initialized() or A.get_mesh() is not None:
        raise RuntimeError("flops_probe runs the unsharded step: no world "
                           "or mesh may be active")
    from torch._subclasses.fake_tensor import FakeTensorMode
    whole = HostMesh((1, 1))
    step = R.step_for(cfg, shape, micro_batches=1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, specs = rank_arguments(cfg, shape, whole)
        batch = _step_inputs(cfg, shape, whole, args["inputs"], specs["inputs"])
        with FlopCounterMode(display=False) as fc:
            _run_step(step, shape, args["params"], args["opt_state"], batch)
    return {"global_flops": fc.get_total_flops(),
            "note": "unsharded eager step on fake tensors; micro_batches=1; "
                    "matmul FLOPs (FlopCounterMode)"}


def _run_step(step, shape: ShapeCfg, params, opt, batch):
    if shape.kind == "train":
        return step(params, opt, batch)
    with torch.no_grad():
        return step(params, batch)


def run_cell(cfg: ModelCfg, shape: ShapeCfg, mesh: HostMesh, *,
             micro_batches: int | None = None, probe: bool = True) -> dict:
    """One cell on any unbound ``mesh``: rank 0 of a fake world of its size
    runs the cell's step once on fake tensors, counted (module
    docstring).  The train step splits into ``micro_batches``
    (``pick_micro_batches`` by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mb = 0
    if shape.kind == "train":
        mb = micro_batches or pick_micro_batches(cfg, shape, mesh)
    step = R.step_for(cfg, shape, micro_batches=max(mb, 1))
    counter = StepCounter()
    with fake_world(mesh.world_size):
        mesh = HostMesh(mesh.sizes, mesh.axis_names).bind()
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                args, specs = rank_arguments(cfg, shape, mesh,
                                             micro_batches=max(mb, 1))
                A.set_mesh(mesh)
                A.set_param_specs(specs["params"])
                counter.track(args)
                t0 = time.perf_counter()
                with FlopCounterMode(display=False) as fc, counter:
                    batch = _step_inputs(cfg, shape, mesh, args["inputs"],
                                         specs["inputs"])
                    out = _run_step(step, shape, args["params"],
                                    args["opt_state"], batch)
                    del batch
                lower_s = time.perf_counter() - t0
                arg_bytes = {k: _distinct_bytes(v) for k, v in args.items()}
                out_own = out_alias = 0
                for st in counter.storages(out):
                    if counter.owns(st):
                        out_own += st.nbytes()
                    else:
                        out_alias += st.nbytes()
                del out
        finally:
            A.set_mesh(None)
            A.set_param_specs(None)
    argument = sum(arg_bytes.values())
    memory = {"argument_bytes": argument, "output_bytes": out_own + out_alias,
              "temp_bytes": counter.peak - out_own, "alias_bytes": out_alias,
              "peak_bytes": argument + counter.peak, "arguments": arg_bytes}
    row = {"kind": shape.kind, "devices": mesh.world_size, "micro_batches": mb,
           "flops": fc.get_total_flops(), "bytes": counter.op_bytes,
           "collective_bytes": counter.bytes,
           "other_collective_bytes": counter.other,
           "collective_calls": counter.grouped(),
           "memory": memory, "lower_s": round(lower_s, 1), "compile_s": None,
           "cost_analysis": None, "params": T.param_count(cfg),
           "active_params": T.active_param_count(cfg)}
    if probe:
        row["probe"] = flops_probe(cfg, shape, mb)
    return row


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               micro_override=None) -> dict:
    """The reference's cell: ``arch`` x ``shape_name`` on the production
    mesh (256 ranks, or 512 with ``multi_pod``)."""
    cfg = R.get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    row = run_cell(cfg, shape, mesh, micro_batches=micro_override)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
            **row}


def cell_path(arch, shape_name, mesh_name) -> Path:
    return results_dir() / f"{arch}__{shape_name}__{mesh_name}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells with existing result files")
    ap.add_argument("--micro", type=int, default=None)
    args = ap.parse_args(argv)

    results_dir().mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    archs = sorted(R.ARCHS) if (args.all or not args.arch) else [args.arch]
    for arch in archs:
        live = [s.name for s in shapes_for(R.get_arch(arch))]
        for sh in ([args.shape] if args.shape else live):
            if sh not in live:
                print(f"SKIP {arch} x {sh}: not applicable (DESIGN.md §5)")
                continue
            cells.extend((arch, sh, mp) for mp in meshes)

    failures = 0
    for arch, sh, mp in cells:
        path = cell_path(arch, sh, mesh_name(mp))
        if args.resume and path.exists():
            print(f"skip (cached) {arch} x {sh} x {mesh_name(mp)}")
            continue
        print(f"=== {arch} x {sh} x {mesh_name(mp)} ===", flush=True)
        try:
            row = lower_cell(arch, sh, mp, micro_override=args.micro)
            atomic_write_json(path, row)
            mem = row["memory"]
            print(f"  ok: flops={row['flops']:.3e} "
                  f"coll={sum(row['collective_bytes'].values()):.3e}B "
                  f"argument={mem['argument_bytes'] / 1e9:.2f}GB "
                  f"temp={mem['temp_bytes'] / 1e9:.2f}GB "
                  f"peak={mem['peak_bytes'] / 1e9:.2f}GB "
                  f"(of {mesh_mod.HBM_BYTES / 1e9:.0f} GB) "
                  f"lower={row['lower_s']}s", flush=True)
        except Exception:
            failures += 1
            path.with_suffix(".err").write_text(traceback.format_exc())
            print(f"  FAIL {arch} x {sh} x {mesh_name(mp)}:", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
