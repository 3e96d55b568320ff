"""AST lint over the port: pluggable checkers for repo-wide source rules
(counterpart of ``repro/analysis/lint.py``).

Unlike the dispatch-mode passes (which watch *running programs*), these
rules check *source text* — conventions the repo adopted after real
incidents, where the dangerous pattern is visible syntactically:

* ``LINT-ATOMIC-IO`` — JSON/bench/checkpoint artifacts must go through
  ``repro_torch._atomic_io`` (tmp-then-``os.replace``).  A raw
  ``open(path, "w")`` + ``json.dump`` can be interrupted mid-write and
  truncate an artifact (a report, a trace, a manifest).
* ``LINT-NP-RANDOM`` — no global-state numpy randomness
  (``np.random.rand`` et al.) and no unseeded ``default_rng()`` in
  library code; every draw must be reproducible from an explicit seed.
* ``LINT-WALLCLOCK`` — no ``time.time()`` in library code: durations
  must use the monotonic clocks (``perf_counter``); wall-clock
  timestamps that *are* metadata belong in the baseline with a reason.
* ``LINT-HOST-SYNC`` — the port's counterpart of the reference's
  ``LINT-INT-TRACER`` (the port traces nothing): no bare ``int(x)``,
  ``float(x)`` or ``bool(x)`` of a value that may be a tensor, and no
  ``.item()`` / ``.tolist()`` / ``.cpu()``, in ``models/*.py`` and
  ``serve/model_step.py``, the code a CUDA graph of a decode step would
  capture: each reads the device back to the host, which blocks capture
  and stalls the stream.  Literals, shapes, ``len()`` / ``round()`` and
  config attributes are exempt, as the reference's ``_INT_SAFE_CALLS``
  exempts them.
* ``LINT-F64-LITERAL`` — no float64 dtype literals in kernel files
  (``*.py`` under a ``kernels/`` directory) and no ``double`` token in the
  CUDA sources (``*.cu``, ``*.cuh``) there: kernels accumulate in f32 over
  bf16/fp16 operands, and f64 runs at 1/64 of the tensor cores' rate.

A checker is a function ``(path, tree, source_lines) -> list[Finding]``
registered in ``CHECKERS``; adding a rule = adding a function and its line
in ``cli.RULE_DOCS``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Callable, Iterable

from repro_torch.analysis.findings import Finding

__all__ = ["lint_paths", "lint_file", "CHECKERS", "CUDA_SUFFIXES"]

Checker = Callable[[str, ast.AST, list[str]], list[Finding]]

# module basenames exempt from the atomic-IO rule: the primitives themselves
_ATOMIC_IO_EXEMPT = {"_atomic_io.py"}

_NP_GLOBAL_FNS = {"rand", "randn", "randint", "random", "random_sample",
                  "choice", "seed", "uniform", "normal", "standard_normal",
                  "permutation", "shuffle", "exponential", "poisson"}

CUDA_SUFFIXES = (".cu", ".cuh")

_F64_HINT = ("kernels accumulate in f32 over bf16/fp16 operands; f64 on the "
             "card runs at 1/64 of the tensor cores' rate and is always an "
             "accident in a kernel — host-side math.* is the sanctioned f64")


def _line(source_lines: list[str], lineno: int) -> str:
    if 1 <= lineno <= len(source_lines):
        return source_lines[lineno - 1].strip()
    return ""


def _finding(rule: str, path: str, node: ast.AST, source_lines: list[str],
             message: str, hint: str) -> Finding:
    return Finding(rule=rule, file=path, line=getattr(node, "lineno", 0),
                   message=message, hint=hint,
                   match=_line(source_lines, getattr(node, "lineno", 0)))


def _dotted(node: ast.AST) -> str:
    """'np.random.rand' for an Attribute chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _mentions_json(node: ast.AST) -> bool:
    """Heuristic: does this expression name a .json artifact?  String
    constants ending in .json, or identifiers containing json/JSON."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and sub.value.endswith(".json"):
            return True
        if isinstance(sub, ast.Name) and "json" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "json" in sub.attr.lower():
            return True
    return False


# ---------------------------------------------------------------------------
# checkers
# ---------------------------------------------------------------------------

def check_atomic_io(path: str, tree: ast.AST,
                    source_lines: list[str]) -> list[Finding]:
    if Path(path).name in _ATOMIC_IO_EXEMPT:
        return []
    out = []
    hint = ("route the write through repro_torch._atomic_io."
            "atomic_write_json (tmp-then-os.replace) so an interrupted run "
            "cannot truncate the artifact")
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        # json.dump(doc, f) — the canonical torn-write shape
        if dotted.endswith("json.dump"):
            out.append(_finding(
                "LINT-ATOMIC-IO", path, node, source_lines,
                "json.dump to a raw file handle — a crash mid-write "
                "truncates the artifact", hint))
        # open(<something json>, "w")
        elif dotted == "open" and node.args:
            mode = ""
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
                mode = str(node.args[1].value)
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = str(kw.value.value)
            if "w" in mode and _mentions_json(node.args[0]):
                out.append(_finding(
                    "LINT-ATOMIC-IO", path, node, source_lines,
                    "raw open(..., 'w') of a .json artifact", hint))
        # path.write_text(json.dumps(...))
        elif dotted.endswith("write_text") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Call) \
                    and _dotted(arg.func).endswith("json.dumps"):
                out.append(_finding(
                    "LINT-ATOMIC-IO", path, node, source_lines,
                    "write_text(json.dumps(...)) — non-atomic JSON "
                    "artifact write", hint))
    return out


def check_np_random(path: str, tree: ast.AST,
                    source_lines: list[str]) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        head = dotted.rsplit(".", 1)[0]
        if head in ("np.random", "numpy.random", "random") \
                and dotted.split(".")[-1] in _NP_GLOBAL_FNS:
            out.append(_finding(
                "LINT-NP-RANDOM", path, node, source_lines,
                f"global-state numpy randomness ({dotted}) in library code",
                "use np.random.default_rng(seed) with an explicit seed (or "
                "a torch.Generator) so the draw is reproducible"))
        elif dotted.endswith("default_rng") and not node.args \
                and not node.keywords:
            out.append(_finding(
                "LINT-NP-RANDOM", path, node, source_lines,
                "unseeded np.random.default_rng() — OS-entropy seeded, "
                "unreproducible",
                "pass an explicit seed"))
    return out


def check_wallclock(path: str, tree: ast.AST,
                    source_lines: list[str]) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted == "time.time":
            out.append(_finding(
                "LINT-WALLCLOCK", path, node, source_lines,
                "time.time() in library code — wall clock steps under NTP "
                "and breaks duration math",
                "use time.perf_counter() for durations; a deliberate "
                "wall-clock *timestamp* (manifest metadata) goes in the "
                "baseline with a reason"))
    return out


_INT_SAFE_CALLS = {"len", "_concrete_int", "round", "ord"}
_SYNC_BUILTINS = {"int", "float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu"}


def _config_attr(node: ast.AST) -> bool:
    """``cfg.x``, ``self.cfg.x.y``, ``config.x``: a field of a frozen
    config, a Python value."""
    parts = _dotted(node).split(".")
    return len(parts) > 1 and any(p in ("cfg", "config") for p in parts[:-1])


def _numpy_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        _dotted(node.func).split(".")[0] in ("np", "numpy")


_SHAPE_ATTRS = ("shape", "ndim", "size", "itemsize")
_SHAPE_METHODS = ("size", "dim", "numel", "element_size")


def _shape_expr(node: ast.AST) -> bool:
    """``x.shape``, ``x.ndim``, ``x.size(1)``, ``x.numel()``: a tensor's
    layout, a host value."""
    if isinstance(node, ast.Attribute):
        return node.attr in _SHAPE_ATTRS
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
        and node.func.attr in _SHAPE_METHODS


def _host_value(arg: ast.AST, names=frozenset(), attrs=frozenset()) -> bool:
    """Expressions that cannot be tensors: literals, len()/round() (the
    reference's ``_INT_SAFE_CALLS``), ``math.*`` calls (a Python number
    whatever they read), shape accesses, config attributes,
    comparisons with a string, ``names`` assigned from such values in the
    enclosing scopes, ``self`` attributes in ``attrs`` (numpy arrays),
    items of any of these, and arithmetic over them."""
    if isinstance(arg, ast.Constant) or _config_attr(arg) or _shape_expr(arg):
        return True
    if isinstance(arg, ast.Name):
        return arg.id in names
    if isinstance(arg, ast.Subscript):
        return _host_value(arg.value, names, attrs)
    if isinstance(arg, ast.Attribute):
        return _dotted(arg.value) == "self" and arg.attr in attrs
    if isinstance(arg, ast.Call):
        name = _dotted(arg.func)
        return name.split(".")[-1] in _INT_SAFE_CALLS \
            or name.startswith("math.")
    if isinstance(arg, ast.Compare):
        return any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                   for c in [arg.left, *arg.comparators])
    if isinstance(arg, ast.BinOp):
        return all(_host_value(s, names, attrs) for s in (arg.left, arg.right))
    if isinstance(arg, ast.UnaryOp):
        return _host_value(arg.operand, names, attrs)
    if isinstance(arg, (ast.Tuple, ast.List)):
        return all(_host_value(e, names, attrs) for e in arg.elts)
    return False


def _host_sync_scope(path: str) -> bool:
    p = Path(path)
    return p.suffix == ".py" and ("models" in p.parts[:-1]
                                  or p.parts[-2:] == ("serve", "model_step.py"))


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _scope_nodes(scope: ast.AST):
    """The nodes of ``scope``, not descending into nested functions (the
    nested function nodes themselves are yielded)."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, _FUNCS):
            todo.extend(ast.iter_child_nodes(node))


def _target_names(t: ast.AST) -> set[str]:
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, (ast.Tuple, ast.List)):
        return set().union(*(_target_names(e) for e in t.elts))
    return set()


def check_host_sync(path: str, tree: ast.AST,
                    source_lines: list[str]) -> list[Finding]:
    """Host reads of device values in the code a decode step runs."""
    if not _host_sync_scope(path):
        return []
    attrs = frozenset(
        t.attr for node in ast.walk(tree)
        if isinstance(node, ast.Assign) and _numpy_call(node.value)
        for t in node.targets
        if isinstance(t, ast.Attribute) and _dotted(t.value) == "self")
    out = []
    hint = ("keep the value on the device (a one-element tensor the kernel "
            "or the next op reads), or hoist the read out of the step; an "
            "accepted read goes in the baseline with a reason")

    def visit(scope, names):
        nodes = list(_scope_nodes(scope))
        names = set(names)
        for _ in range(2):   # names assigned from names assigned later
            for n in nodes:
                if isinstance(n, ast.Assign) and _host_value(n.value, names,
                                                             attrs):
                    for t in n.targets:
                        names |= _target_names(t)
        for node in nodes:
            if isinstance(node, _FUNCS):
                visit(node, names)
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _SYNC_BUILTINS and node.args \
                    and not _host_value(node.args[0], names, attrs):
                out.append(_finding(
                    "LINT-HOST-SYNC", path, node, source_lines,
                    f"bare {node.func.id}(...) of a value that may be a "
                    "tensor — a host read that blocks CUDA-graph capture",
                    hint))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args \
                    and not node.keywords \
                    and not _numpy_call(node.func.value):
                out.append(_finding(
                    "LINT-HOST-SYNC", path, node, source_lines,
                    f".{node.func.attr}() — copies device data to the host "
                    "and blocks CUDA-graph capture", hint))

    visit(tree, ())
    return sorted(out, key=lambda f: f.line)


def _kernel_file(path: str) -> bool:
    return "kernels" in Path(path).parts


def check_f64_literal(path: str, tree: ast.AST,
                      source_lines: list[str]) -> list[Finding]:
    if not _kernel_file(path):
        return []
    out = []
    for node in ast.walk(tree):
        bad = None
        if isinstance(node, ast.Attribute) and node.attr == "float64":
            bad = _dotted(node)
        elif isinstance(node, ast.Constant) and node.value == "float64":
            bad = "'float64'"
        if bad:
            out.append(_finding(
                "LINT-F64-LITERAL", path, node, source_lines,
                f"float64 literal ({bad}) in a kernel file", _F64_HINT))
    return out


CHECKERS: dict[str, Checker] = {
    "LINT-ATOMIC-IO": check_atomic_io,
    "LINT-NP-RANDOM": check_np_random,
    "LINT-WALLCLOCK": check_wallclock,
    "LINT-HOST-SYNC": check_host_sync,
    "LINT-F64-LITERAL": check_f64_literal,
}

# comments and string or character literals of C++, blanked before the scan
_CPP_SKIP = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"'
                       r"|'(?:\\.|[^'\\\n])*'", re.DOTALL)
_DOUBLE = re.compile(r"\bdouble\b")


def cuda_f64_tokens(path: str, source: str) -> list[Finding]:
    """``LINT-F64-LITERAL`` in a CUDA source under ``kernels/``: every
    ``double`` token outside comments and literals."""
    if not _kernel_file(path):
        return []
    code = _CPP_SKIP.sub(lambda m: re.sub(r"[^\n]", " ", m.group()), source)
    lines = source.splitlines()
    out = []
    for i, text in enumerate(code.splitlines(), 1):
        if _DOUBLE.search(text):
            out.append(Finding(
                rule="LINT-F64-LITERAL", file=path, line=i,
                message="double in a CUDA kernel source", hint=_F64_HINT,
                match=_line(lines, i)))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def lint_file(path: str | Path, *, root: str | Path | None = None,
              checkers: Iterable[str] | None = None) -> list[Finding]:
    path = Path(path)
    rel = str(path if root is None else path.relative_to(root))
    source = path.read_text()
    if path.suffix in CUDA_SUFFIXES:
        if checkers is not None and "LINT-F64-LITERAL" not in checkers:
            return []
        return cuda_f64_tokens(rel, source)
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(rule="LINT-SYNTAX", file=rel, line=e.lineno or 0,
                        message=f"file does not parse: {e.msg}",
                        hint="fix the syntax error", match="")]
    lines = source.splitlines()
    out: list[Finding] = []
    for name, checker in CHECKERS.items():
        if checkers is not None and name not in checkers:
            continue
        out.extend(checker(rel, tree, lines))
    return out


def lint_paths(paths: Iterable[str | Path], *,
               root: str | Path | None = None,
               checkers: Iterable[str] | None = None) -> list[Finding]:
    """Lint every ``*.py`` under each path, and every ``*.cu`` / ``*.cuh``
    (files accepted directly)."""
    out: list[Finding] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files = sorted(f for f in p.rglob("*")
                           if f.suffix in (".py",) + CUDA_SUFFIXES)
        else:
            files = [p]
        for f in files:
            out.extend(lint_file(f, root=root, checkers=checkers))
    return out
