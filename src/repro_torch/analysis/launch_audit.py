"""Launch audit of the port's four CUDA kernels (counterpart of
``repro/analysis/pallas_audit.py``).

The reference proves its Pallas kernels' BlockSpecs from the traced
``GridMapping``.  A CUDA launch has no such object, so each kernel wrapper
keeps a plain-Python ``launch_grid(...)`` beside it that gives the grid its
``.cu`` launch line uses and the region of each buffer that a block index
writes, following the kernel's indexing.  The audit enumerates the grid at
small shapes (up to ``MAX_GRID_POINTS`` blocks, as ``pallas_audit`` does)
and proves:

* **Write disjointness** (rule ``CUDA-WRITE-ALIAS``): no two blocks of one
  launch, which may run at once, write the same element.  Launches on one
  stream run in turn, so a later launch may rewrite what an earlier one
  wrote (the split-K reduction writes C from the workspace).  Blocks that
  share a ticket write a region once between them (kernel 4's merge: the
  block that draws the row's last ticket).
* **Coverage** (rule ``CUDA-COVERAGE``): every element of each buffer the
  plan names as covered (the output; the split-K workspace, which the
  reduction reads whole) is written by some block, and no block writes
  outside a buffer.  The outputs are ``torch.empty`` tensors: an element no
  block writes is garbage, not an error.
* **Shared memory** (rule ``CUDA-SMEM``, :func:`audit_smem`): a block's
  dynamic shared memory, from the wrappers' own ``smem_bytes``, is within
  sm_90's opt-in limit of 232,448 bytes.
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels._grid import LaunchPlan

__all__ = ["audit_launches", "audit_smem", "poisoned_launches",
           "MAX_GRID_POINTS", "SMEM_LIMIT"]

MAX_GRID_POINTS = 65536
# sm_90's dynamic shared memory a block may opt in to (227 KB of the SM's
# 256 KB, cudaFuncAttributeMaxDynamicSharedMemorySize)
SMEM_LIMIT = 232448


def _blocks(grid: tuple[int, ...]):
    return np.ndindex(*grid)


def audit_launches(plan: LaunchPlan, *, what: str = "kernel",
                   max_grid_points: int = MAX_GRID_POINTS) -> list[Finding]:
    """Prove write disjointness within each launch of ``plan`` and coverage
    of its covered buffers; returns findings (empty = proven for this
    shape)."""
    findings: list[Finding] = []
    written = {name: np.zeros(shape, bool) for name, shape in plan.buffers.items()}
    for launch in plan.launches:
        total = math.prod(launch.grid)
        if total > max_grid_points:
            findings.append(Finding(
                rule="CUDA-WRITE-ALIAS", file=what, line=0,
                message=(f"grid {launch.grid} of {launch.kernel} too large "
                         f"to enumerate ({total} > {max_grid_points}) — "
                         "audit a smaller shape"),
                hint="the properties are structural: a small grid proves "
                     "the same indexing",
                match=f"{what}:{launch.kernel}:grid_too_large"))
            continue
        # per buffer: which writer (block or ticket) owns each element
        owner = {name: np.full(shape, -1, np.int64)
                 for name, shape in plan.buffers.items()}
        writers: dict = {}
        aliased = set()
        for idx in _blocks(launch.grid):
            for w in launch.writes(idx):
                key = ("ticket", w.ticket) if w.ticket is not None else idx
                wid = writers.setdefault(key, len(writers))
                own = owner[w.buffer].reshape(-1) if w.flat else owner[w.buffer]
                if not _inside(own.shape, w.region):
                    findings.append(Finding(
                        rule="CUDA-COVERAGE", file=what, line=0,
                        message=(f"{launch.kernel} block {idx} writes "
                                 f"{w.buffer}[{_fmt(w.region)}] outside its "
                                 f"shape {own.shape}"),
                        hint="clip the block's rows to the buffer as the "
                             "kernel's guards do",
                        match=f"{what}:{launch.kernel}:outside:{w.buffer}"))
                    continue
                region = own[w.region]
                others = np.unique(region[(region != -1) & (region != wid)])
                if others.size and w.buffer not in aliased:
                    aliased.add(w.buffer)
                    other = next(k for k, v in writers.items()
                                 if v == others[0])
                    findings.append(Finding(
                        rule="CUDA-WRITE-ALIAS", file=what, line=0,
                        message=(f"{launch.kernel} of grid {launch.grid}: "
                                 f"blocks {other} and {idx} both write "
                                 f"{w.buffer}[{_fmt(w.region)}]"),
                        hint="make the block -> region map injective, or "
                             "give the shared region one writer (a ticket) "
                             "or a separate launch",
                        match=f"{what}:{launch.kernel}:alias:{w.buffer}"))
                own[w.region] = wid
                view = (written[w.buffer].reshape(-1) if w.flat
                        else written[w.buffer])
                view[w.region] = True
    for name in plan.covered:
        missing = ~written[name]
        if missing.any():
            first = tuple(int(i) for i in np.argwhere(missing)[0])
            findings.append(Finding(
                rule="CUDA-COVERAGE", file=what, line=0,
                message=(f"{int(missing.sum())} of {missing.size} elements "
                         f"of {name} {written[name].shape} are written by no "
                         f"block (first {first})"),
                hint="the output is uninitialised memory: every element "
                     "needs a block that writes it",
                match=f"{what}:uncovered:{name}"))
    return findings


def _inside(shape: tuple[int, ...], region: tuple) -> bool:
    region = region if isinstance(region, tuple) else (region,)
    for n, r in zip(shape, region):
        if isinstance(r, slice):
            if r.start is not None and not 0 <= r.start <= n:
                return False
            if r.stop is not None and not 0 <= r.stop <= n:
                return False
        elif not 0 <= int(r) < n:
            return False
    return True


def _fmt(region) -> str:
    region = region if isinstance(region, tuple) else (region,)
    return ", ".join(f"{r.start}:{r.stop}" if isinstance(r, slice) else str(r)
                     for r in region)


def audit_smem(entries: Iterable[tuple[str, int]], *, what: str = "kernel",
               limit: int = SMEM_LIMIT) -> list[Finding]:
    """``CUDA-SMEM`` for each (description, bytes) above ``limit``."""
    return [Finding(
        rule="CUDA-SMEM", file=what, line=0,
        message=(f"{desc} needs {nbytes} bytes of dynamic shared memory, "
                 f"above sm_90's {limit}"),
        hint="shrink the tile or the ring, or refuse the plan in the planner",
        match=f"{what}:smem:{desc}") for desc, nbytes in entries if nbytes > limit]


def poisoned_launches(device="cuda") -> dict[str, dict]:
    """The audit held against the kernels: each of the four runs once with
    its output (and its workspace) filled with NaN first — kernels 1 and 2
    with 4 splits, kernel 3 at G 7 and causal over a ragged 300 positions,
    kernel 4 with P 4 at a clock and a mix of compressed slots — and once
    normally.  Per kernel: NaNs left in the output, NaNs left in the
    workspace elements its ``launch_grid`` says are written (checked on the
    card; the plain versions on the CPU write no workspace), whether the
    two results are equal bit for bit, and the launches made."""
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2

    dev = torch.device(device)
    card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(20)
    nan = float("nan")

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def nans(shape, dtype=torch.float32):
        return torch.full(shape, nan, dtype=dtype, device=dev)

    def written_nans(plan, name, buf) -> int:
        mask = np.zeros(plan.buffers[name], bool)
        for launch in plan.launches:
            for idx in _blocks(launch.grid):
                for w in launch.writes(idx):
                    if w.buffer == name:
                        (mask.reshape(-1) if w.flat else mask)[w.region] = True
        got = torch.isnan(buf.reshape(plan.buffers[name])).cpu().numpy()
        return int((got & mask).sum())

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    def bits(t):
        return t.contiguous().view(torch.uint8)

    def record(counter, run, normal, out, ws=None, plan=None):
        """The poisoned launch, its NaNs read before the normal launch
        (kernel 4's normal launch reuses the cached workspace)."""
        sync()
        before = counter.launches
        got = run()
        sync()
        rec = {"nan_out": int(torch.isnan(got).sum()),
               "nan_workspace": (written_nans(plan, "workspace", ws)
                                 if card and ws is not None else 0),
               "launches": counter.launches - before,
               "into_out": got.data_ptr() == out.data_ptr()}
        rec["bitwise"] = bool(torch.equal(bits(got), bits(normal())))
        return rec

    res = {}
    m, k, n, bm, bn, bk, splits = 256, 512, 96, 128, 32, 64, 4
    a, b = rnd(m, k, scale=k ** -0.5), rnd(k, n, dtype=torch.bfloat16)
    for name, mod, call in (
            ("shgemm", k1, lambda **kw: k1.shgemm_pallas(
                a, b, bm=bm, bn=bn, bk=bk, splits=splits, **kw)),
            ("shgemm_fused", k2, lambda **kw: k2.shgemm_fused_pallas(
                a, (0x5EED, 20), n, bm=bm, bn=bn, bk=bk, splits=splits, **kw))):
        out, ws = nans((m, n)), nans((k // bk, m, n))
        res[name] = record(mod, lambda: call(out=out, workspace=ws), call,
                           out, ws, k1.launch_grid(m, n, k, bm, bn, bk, splits))

    bt, s, kv, g, hd = 1, 300, 2, 7, 64
    q = rnd(bt, s, g * kv, hd, dtype=torch.bfloat16)
    kk, vv = rnd(bt, s, kv, hd, dtype=torch.bfloat16), rnd(bt, s, kv, hd,
                                                            dtype=torch.bfloat16)
    out = nans(tuple(q.shape), torch.bfloat16)
    res["flash_attention"] = record(
        k3,
        lambda: k3.flash_attention(q, kk, vv, causal=True, out=out),
        lambda: k3.flash_attention(q, kk, vv, causal=True), out)

    bt, kvh, g, hd, r, s, wp, splits = 2, 2, 2, 128, 8, 512, 300, 4
    q = rnd(bt, 1, g * kvh, hd, dtype=torch.bfloat16)
    kc, vc = rnd(bt, s, kvh, hd, dtype=torch.bfloat16), rnd(bt, s, kvh, hd,
                                                             dtype=torch.bfloat16)
    k_us, v_us = rnd(bt, kvh, s, r), rnd(bt, kvh, s, r)
    k_vt, v_vt = rnd(bt, kvh, r, hd, scale=0.1), rnd(bt, kvh, r, hd, scale=0.1)
    comp = torch.tensor([128, 0], dtype=torch.int32, device=dev)
    args = (q, kc, vc, k_us, k_vt, v_us, v_vt, comp, wp)
    plan = k4.decode_plan(bt, kvh, s, hd, r, g, splits=splits)
    out, ws = nans(tuple(q.shape), torch.bfloat16), None
    if card:
        stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
        ws = k4._scratch_buffers(dev.index or 0, stream, bt * kvh,
                                 plan.workspace)[1][:plan.workspace]
        ws.fill_(nan)
    res["factored_decode"] = record(
        k4,
        lambda: k4.factored_decode_attention(*args, scale=hd ** -0.5,
                                             splits=splits, out=out),
        lambda: k4.factored_decode_attention(*args, scale=hd ** -0.5,
                                             splits=splits), out, ws,
        k4.launch_grid(bt, kvh, hd, r, g, plan, wp, [128, 0]))
    return res
