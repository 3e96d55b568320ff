"""Dispatch-mode passes: no_gemm, dtype_flow, determinism (counterpart of
``repro/analysis/jaxpr_passes.py``).

Eager PyTorch has no traced program to walk, so each pass runs the entry
point once under a ``TorchDispatchMode`` (tiny shapes, on the CPU or on the
card where the inputs are) and watches every aten operator it dispatches:

* :func:`no_gemm` — no matrix-multiply operator (``GEMM_OPS``) runs.  The
  port's kernels launch through ``ctypes``, out of the dispatcher's sight,
  so the pass also reports any launch the four kernel wrappers count during
  the call.  Rule ``TORCH-NO-GEMM``.
* :func:`dtype_flow` — labels designated inputs (A, the key / Omega
  stream, ...) and carries the labels along the dataflow: an operator's
  outputs take the union of its inputs' labels, an in-place operator adds
  them to the tensor it writes (and to that tensor's base), views keep
  them.  Every float downcast along a labelled path (``_to_copy`` /
  ``to`` to a narrower float, ``copy_`` into a narrower destination, any
  operator whose float output is narrower than a float input) must be in
  the contract's allowlist (``TORCH-DTYPE-CAST``); an f64 result on a
  labelled path is ``TORCH-F64``; with ``report_weak``, a Python scalar or
  a 0-dim tensor mixing into labelled float arithmetic is
  ``TORCH-WEAK-PROMOTE``.  Python scalars carry no identity: a labelled
  argument that is not a tensor (the port's keys are pairs of ints), and a
  scalar read from a labelled tensor, label the operators that take one of
  their integers by value, so contracts use key words that occur nowhere
  else.
* :func:`determinism` — a random operator without an explicit
  ``generator`` (``TORCH-UNKEYED``), an entry point whose output does not
  change with its key (``TORCH-UNKEYED``), an accumulating float scatter,
  whose atomics make it nondeterministic on CUDA (``TORCH-NONDET``), and a
  second run with the same key that gives other bits (``TORCH-NONDET``).

Findings are anchored at the first stack frame inside ``src/repro_torch``
outside ``analysis/`` (the frame of the caller's own code where the
operator ran outside the package), as the reference anchors at the
equation's source line.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.analysis.findings import Finding

__all__ = ["no_gemm", "dtype_flow", "determinism", "GEMM_OPS", "RANDOM_OPS",
           "NONDET_SCATTER_OPS", "kernel_launches"]

# aten operator names (``OpOverloadPacket.__name__``) of matrix products
GEMM_OPS = ("mm", "bmm", "addmm", "addmm_", "baddbmm", "baddbmm_", "addbmm",
            "addbmm_", "_scaled_mm", "convolution", "linear")

RANDOM_OPS = ("normal", "normal_", "uniform_", "bernoulli", "bernoulli_",
              "randperm", "multinomial", "exponential_", "cauchy_",
              "log_normal_", "geometric_", "poisson")

# accumulating scatters: order-dependent float atomics on CUDA
NONDET_SCATTER_OPS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
                      "scatter_reduce", "scatter_reduce_", "index_reduce",
                      "index_reduce_")
_ACCUMULATE_OPS = ("index_put", "index_put_", "_index_put_impl_", "put",
                   "put_")

_ARITH_OPS = ("add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div",
              "div_", "maximum", "minimum")

_PORT = Path(__file__).resolve().parents[1]
_ANALYSIS = Path(__file__).resolve().parent
_REPO = _PORT.parents[1]
_TORCH = Path(torch.__file__).resolve().parent


def kernel_launches() -> dict[str, int]:
    """The four kernel wrappers' launch counters."""
    from repro_torch.kernels import (factored_decode, flash_attention, shgemm,
                                     shgemm_fused)
    return {"shgemm": shgemm.launches, "shgemm_fused": shgemm_fused.launches,
            "flash_attention": flash_attention.launches,
            "factored_decode": factored_decode.launches}


def _rel(path: Path) -> str:
    try:
        return str(path.relative_to(_REPO))
    except ValueError:
        return str(path)


def _anchor() -> tuple[str, int]:
    """(file, line) of the innermost frame in the port outside analysis/,
    else of the innermost frame outside torch, analysis/ and the standard
    library's dispatch machinery."""
    frame = sys._getframe(1)
    fallback = None
    while frame is not None:
        path = Path(frame.f_code.co_filename).resolve()
        inside = _ANALYSIS in path.parents
        if not inside and _PORT in path.parents:
            return _rel(path), frame.f_lineno
        if fallback is None and not inside and _TORCH not in path.parents \
                and path.name != "contextlib.py":
            fallback = (_rel(path), frame.f_lineno)
        frame = frame.f_back
    return fallback or ("<dispatch>", 0)


def _name(func) -> str:
    return func.overloadpacket.__name__


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _ints(tree) -> list[int]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, int) and not isinstance(x, bool)]


class _Watch(TorchDispatchMode):
    """Calls ``on_op(func, args, kwargs, out)`` after every operator."""

    def __init__(self, on_op):
        super().__init__()
        self.on_op = on_op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.on_op(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# no_gemm
# ---------------------------------------------------------------------------

def no_gemm(fn: Callable, *args, denied: Sequence[str] = GEMM_OPS,
            what: str = "program") -> list[Finding]:
    """Run ``fn(*args)`` and report every denied operator and every kernel
    launch (rule ``TORCH-NO-GEMM``)."""
    findings: list[Finding] = []
    hint = ("structured applies must use adds/gathers only (DESIGN.md §17); "
            "if a GEMM is intentional, check a different entry point or drop "
            "the contract")

    def on_op(func, args, kwargs, out):
        name = _name(func)
        if name in denied:
            file, line = _anchor()
            findings.append(Finding(
                rule="TORCH-NO-GEMM", file=file, line=line,
                message=f"aten.{name} in {what} contracted to be GEMM-free",
                hint=hint, match=f"{what}:{name}"))

    before = kernel_launches()
    with _Watch(on_op):
        fn(*args)
    for kernel, n in kernel_launches().items():
        if n != before[kernel]:
            findings.append(Finding(
                rule="TORCH-NO-GEMM", file=what, line=0,
                message=(f"{n - before[kernel]} launch(es) of kernel "
                         f"{kernel} in {what} contracted to be GEMM-free"),
                hint=hint, match=f"{what}:kernel:{kernel}"))
    return findings


# ---------------------------------------------------------------------------
# dtype_flow
# ---------------------------------------------------------------------------

_FLOAT_BITS = {torch.bfloat16: 16, torch.float16: 16, torch.float32: 32,
               torch.float64: 64, torch.float8_e4m3fn: 8,
               torch.float8_e5m2: 8}


def _dt(d: torch.dtype) -> str:
    return str(d).removeprefix("torch.")


class _Labels:
    """Labels of tensors (by identity, weakly) and of integers (by value)."""

    def __init__(self):
        self.tensors = WeakTensorKeyDictionary()
        self.ints: dict[int, frozenset] = {}

    def of(self, t: torch.Tensor) -> frozenset:
        labs = self.tensors.get(t, frozenset())
        base = t._base
        return labs | self.tensors.get(base, frozenset()) if base is not None \
            else labs

    def add(self, t: torch.Tensor, labs: frozenset) -> None:
        if labs:
            self.tensors[t] = self.tensors.get(t, frozenset()) | labs

    def label_arg(self, arg, label: str) -> None:
        for t in _tensors(arg):
            self.add(t, frozenset({label}))
        for v in _ints(arg):
            self.ints[v] = self.ints.get(v, frozenset()) | {label}


def _mutated(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors an operator writes in place (``self`` of ``add_``, the
    ``out=`` of an out variant)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        val = args[i] if i < len(args) and not a.kwarg_only else kwargs.get(a.name)
        out.extend(_tensors(val))
    return out


def dtype_flow(fn: Callable, *args,
               labels: Optional[dict[int, str]] = None,
               allow: Iterable[tuple[str, str, str]] = (),
               report_weak: bool = False,
               what: str = "program") -> list[Finding]:
    """Report every float downcast along labelled paths that ``allow`` does
    not list (rule ``TORCH-DTYPE-CAST``) and every f64 result on a labelled
    path (``TORCH-F64``); with ``report_weak``, weak scalars mixing into
    labelled float arithmetic (``TORCH-WEAK-PROMOTE``).

    ``labels`` maps positional arg index -> label name.  ``allow`` entries
    are ``(label, src, dst)`` dtype-name triples; ``("*", src, dst)``
    allows the cast on every path, and an unlabelled cast is checked against
    the wildcard only.  A value carrying several labels may only be
    downcast if every label's contract allows it."""
    allow = set(allow)
    findings: list[Finding] = []
    lab = _Labels()
    for i, name in (labels or {}).items():
        lab.label_arg(args[i], name)

    def allowed(labs: frozenset, src: str, dst: str) -> bool:
        if ("*", src, dst) in allow:
            return True
        return bool(labs) and all((lb, src, dst) in allow for lb in labs)

    def on_op(func, args, kwargs, out):
        name = _name(func)
        ins = _tensors((args, kwargs))
        in_labs = frozenset().union(*(lab.of(t) for t in ins)) if ins \
            else frozenset()
        for v in _ints((args, kwargs)):
            in_labs |= lab.ints.get(v, frozenset())
        outs = _tensors(out)
        if name == "_local_scalar_dense" and in_labs and isinstance(out, int):
            lab.ints[out] = lab.ints.get(out, frozenset()) | in_labs
        # downcasts: a float output narrower than a (non-scalar) float input
        for o in outs:
            if o.dtype not in _FLOAT_BITS:
                continue
            for t in ins:
                if t is o or t.dim() == 0 or t.dtype not in _FLOAT_BITS \
                        or _FLOAT_BITS[t.dtype] <= _FLOAT_BITS[o.dtype]:
                    continue
                src, dst, labs = _dt(t.dtype), _dt(o.dtype), lab.of(t)
                if not allowed(labs, src, dst):
                    file, line = _anchor()
                    path = ",".join(sorted(labs)) or "<unlabeled>"
                    findings.append(Finding(
                        rule="TORCH-DTYPE-CAST", file=file, line=line,
                        message=(f"{src} -> {dst} downcast ({name}) on the "
                                 f"[{path}] path of {what} is not in the "
                                 "precision allowlist"),
                        hint=("precision may only be lowered where the "
                              "contract says so (Omega storage, split terms "
                              "— DESIGN.md §18); add an allowlist entry only "
                              "with a numerics argument"),
                        match=f"{what}:{path}:{src}->{dst}"))
        if in_labs and any(o.dtype == torch.float64 for o in outs):
            file, line = _anchor()
            findings.append(Finding(
                rule="TORCH-F64", file=file, line=line,
                message=f"float64 value produced by aten.{name} in {what}",
                hint="the port computes in f32 and below; f64 on the card is "
                     "always an accident (host-side math.sqrt is fine)",
                match=f"{what}:f64:{name}"))
        if report_weak and name in _ARITH_OPS:
            strong = [t for t in args if isinstance(t, torch.Tensor)
                      and t.dim() > 0 and t.dtype in _FLOAT_BITS]
            weak = [a for a in args
                    if (isinstance(a, (int, float)) and not isinstance(a, bool))
                    or (isinstance(a, torch.Tensor) and a.dim() == 0)]
            labs = frozenset().union(*(lab.of(t) for t in strong)) if strong \
                else frozenset()
            if weak and labs:
                file, line = _anchor()
                path = ",".join(sorted(labs))
                findings.append(Finding(
                    rule="TORCH-WEAK-PROMOTE", file=file, line=line,
                    message=(f"weak scalar mixes into the [{path}] path of "
                             f"{what} at aten.{name}"),
                    hint="pin the scalar as a tensor of the path's dtype "
                         "and shape so promotion cannot drift",
                    match=f"{what}:{path}:weak:{name}"))
        for o in outs:
            lab.add(o, in_labs)
        for t in _mutated(func, args, kwargs):
            lab.add(t, in_labs)
            if t._base is not None:
                lab.add(t._base, in_labs)

    with _Watch(on_op):
        fn(*args)
    return findings


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def _same_bits(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.numel() and not torch.equal(x.detach().contiguous().view(torch.uint8),
                                         y.detach().contiguous().view(torch.uint8)):
            return False
    return True


def _other_key(key):
    """A different key of the same kind: the last integer word flipped."""
    if isinstance(key, torch.Tensor):
        return key ^ 1
    words = list(key)
    words[-1] = words[-1] ^ 1
    return type(key)(words)


def _fn_anchor(fn: Callable) -> tuple[str, int]:
    code = getattr(fn, "__code__", None)
    if code is None:
        return "<callable>", 0
    return _rel(Path(code.co_filename).resolve()), code.co_firstlineno


def determinism(fn: Callable, *args, key_arg: Optional[int] = None,
                what: str = "program") -> list[Finding]:
    """Flag nondeterminism hazards (rules ``TORCH-UNKEYED``,
    ``TORCH-NONDET``): unkeyed random operators and accumulating float
    scatters in one run; a second run with the same arguments must give the
    same bits, and with ``key_arg`` (the key's position) a run with the
    key's last word flipped must change the output."""
    findings: list[Finding] = []
    unkeyed = []

    def on_op(func, args, kwargs, out):
        name = _name(func)
        if (name.startswith("rand") or name in RANDOM_OPS) \
                and kwargs.get("generator") is None:
            file, line = _anchor()
            unkeyed.append(name)
            findings.append(Finding(
                rule="TORCH-UNKEYED", file=file, line=line,
                message=(f"aten.{name} in {what} draws from the global "
                         "generator — the randomness is not keyed by any "
                         "input"),
                hint="thread a key (or a torch.Generator seeded from one) "
                     "through the entry point",
                match=f"{what}:global_rng:{name}"))
        accumulate = name in NONDET_SCATTER_OPS or (
            name in _ACCUMULATE_OPS
            and (kwargs.get("accumulate") or any(a is True for a in args[2:])))
        dest = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if accumulate and dest is not None and dest.dtype in _FLOAT_BITS:
            file, line = _anchor()
            findings.append(Finding(
                rule="TORCH-NONDET", file=file, line=line,
                message=(f"accumulating float scatter (aten.{name}) in "
                         f"{what} — atomics order is nondeterministic on "
                         "CUDA"),
                hint="use unique indices, a sort-then-reduce, or a gather "
                     "with a deterministic layout",
                match=f"{what}:{name}"))

    with _Watch(on_op):
        first = fn(*args)
    again = fn(*args)
    if not unkeyed and not _same_bits(first, again):
        file, line = _fn_anchor(fn)
        findings.append(Finding(
            rule="TORCH-NONDET", file=file, line=line,
            message=f"two runs of {what} with the same key gave other bits",
            hint="find the nondeterministic operator (an atomic, a "
                 "nondeterministic algorithm) and replace it",
            match=f"{what}:rerun"))
    if key_arg is not None:
        args2 = list(args)
        args2[key_arg] = _other_key(args[key_arg])
        if _same_bits(first, fn(*args2)):
            file, line = _fn_anchor(fn)
            findings.append(Finding(
                rule="TORCH-UNKEYED", file=file, line=line,
                message=f"{what} gives the same output under two keys",
                hint="the key must reach every random draw of the entry "
                     "point",
                match=f"{what}:key_ignored"))
    return findings
