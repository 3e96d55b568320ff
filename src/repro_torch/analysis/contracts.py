"""The port's contract catalog: which entry points run under which passes,
and the precision allowlists that encode the paper's rules (counterpart of
``repro/analysis/contracts.py``, with the same names, shapes and
allowlists, and two more audits: ``shgemm-audit`` and
``flash-attention-audit``, so all four kernels are audited).

Every contract is a named callable ``contract(device) -> list[Finding]``;
the CLI runs the whole catalog (plus the AST lint).  The dispatch-mode
contracts run their entry point at tiny shapes on ``device`` (the CPU by
default: the operators an entry point dispatches are the same on either
device, save the kernels' plain versions, which are counted as launches on
the card); the launch audits are pure Python.  The catalog runs in seconds.

Adding an invariant: write a function returning ``list[Finding]``, add it
to ``CONTRACTS``, and document its rule ids in ``cli.RULE_DOCS``.  Do NOT
add a one-off assert in a test instead — contracts run against the
*current* library entry points on every change.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Callable

import torch

from repro_torch.analysis.dispatch_passes import determinism, dtype_flow, no_gemm
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.launch_audit import audit_launches, audit_smem

__all__ = ["CONTRACTS", "run_repo_contracts"]

# Key words that occur nowhere else in the entry points: dtype_flow labels
# the operators that take them by value (the port's keys are ints).
_KEY = (0x13579BDF, 0x2468ACE0)

def _matrix(shape, device) -> torch.Tensor:
    """A fixed nonzero input (a zero A would hide a key that is ignored)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# SRHT: the structured apply must never run a GEMM (DESIGN.md §17)
# ---------------------------------------------------------------------------

def srht_no_gemm(device="cpu") -> list[Finding]:
    from repro_torch.core import projection as proj
    a = _matrix((16, 32), device)
    out: list[Finding] = []
    for method in ("f32", "shgemm", "shgemm_fused"):
        out.extend(no_gemm(
            lambda key, a, m=method: proj.sketch(key, a, 8, dist="srht",
                                                 method=m, device=a.device),
            _KEY, a, what=f"sketch(dist='srht', method='{method}')"))
    return out


# ---------------------------------------------------------------------------
# dtype flow: where precision may be lowered (the paper's SHGEMM contract)
# ---------------------------------------------------------------------------

# bf16 mode (repo default): A may be split into bf16 terms, the Omega
# stream (everything derived from the key) may be stored bf16.  Nothing may
# touch f16, and the accumulator path has no allowlisted downcast at all.
_BF16_ALLOW = (
    ("A", "float32", "bfloat16"),
    ("key", "float32", "bfloat16"),
)

# fp16 mode: the paper's Eq. 37-40 splits A into *scaled* f16 terms, so
# A->f16 and key->f16 are the sanctioned casts there.
_FP16_ALLOW = (
    ("A", "float32", "float16"),
    ("key", "float32", "float16"),
)


def sketch_dtype_flow(device="cpu") -> list[Finding]:
    from repro_torch.core import projection as proj
    a = _matrix((16, 32), device)
    out: list[Finding] = []
    for method in ("f32", "shgemm", "lowp_single", "shgemm_fused"):
        out.extend(dtype_flow(
            lambda key, a, m=method: proj.sketch(key, a, 8, method=m,
                                                 device=a.device),
            _KEY, a, labels={0: "key", 1: "A"}, allow=_BF16_ALLOW,
            what=f"sketch(method='{method}', omega_dtype=bf16)"))
    out.extend(dtype_flow(
        lambda key, a: proj.sketch(key, a, 8, method="shgemm",
                                   omega_dtype=torch.float16, device=a.device),
        _KEY, a, labels={0: "key", 1: "A"}, allow=_FP16_ALLOW,
        what="sketch(method='shgemm', omega_dtype=f16)"))
    return out


def stream_update_dtype_flow(device="cpu") -> list[Finding]:
    """The streaming hot path inherits the same precision contract: a row
    tile absorbed by ``stream.update`` may lower precision only on the split
    terms and the Omega stream."""
    from repro_torch.stream import state as st
    a_tile = _matrix((8, 32), device)

    def run(key, tile):
        s = st.init(key, 32, 8, max_rows=8, method="shgemm",
                    omega_dtype=torch.bfloat16, device=tile.device)
        return st.update(s, tile, 0).y

    return dtype_flow(run, _KEY, a_tile, labels={0: "key", 1: "A"},
                      allow=_BF16_ALLOW, what="stream.update(shgemm)")


# ---------------------------------------------------------------------------
# determinism: library entry points may only consume caller-provided keys
# ---------------------------------------------------------------------------

def sketch_determinism(device="cpu") -> list[Finding]:
    from repro_torch.core import projection as proj
    a = _matrix((16, 32), device)
    out: list[Finding] = []
    for method, dist in (("shgemm", "gaussian"), ("shgemm_fused", "gaussian"),
                         ("f32", "srht")):
        out.extend(determinism(
            lambda key, a, m=method, d=dist: proj.sketch(
                key, a, 8, method=m, dist=d, device=a.device),
            _KEY, a, key_arg=0, what=f"sketch(method='{method}', dist='{dist}')"))
    return out


# ---------------------------------------------------------------------------
# gauge audit: no weak promotion into the streamed accumulators
# ---------------------------------------------------------------------------

def stream_b_accumulation_weak_audit(device="cpu") -> list[Finding]:
    """The B = QᵀA accumulation is the f32 summation whose order and dtype
    the resume contract pins (DESIGN.md §14); a weak Python scalar mixing
    into it would let promotion change the summation dtype silently."""
    from repro_torch.kernels.ref import dot_f32 as _dot   # rsvd._dot
    q = _matrix((16, 4), device)
    blk = _matrix((8, 12), device)

    def accumulate(q, blk):
        b = torch.zeros((q.shape[1], 12), dtype=torch.float32, device=q.device)
        return b + _dot(q[:8].T, blk)

    return dtype_flow(accumulate, q, blk, labels={0: "A", 1: "A"},
                      allow=_BF16_ALLOW, report_weak=True,
                      what="resilience B-phase accumulation")


# ---------------------------------------------------------------------------
# launch audits of the four CUDA kernels (DESIGN.md §9/§16 counterparts)
# ---------------------------------------------------------------------------

def _shipped(suffix: str) -> list[tuple[str, dict]]:
    """The shipped autotune cache's entries whose key ends in ``suffix``."""
    from repro_torch.kernels.autotune import default_cache_path
    doc = json.loads(Path(default_cache_path()).read_text())
    return [(k, v) for k, v in doc.items() if k.endswith(suffix)]


def _gemm_audit(module, what: str, suffix: str) -> list[Finding]:
    """Every tile at split counts 1, 2 and 4 (4 bk tiles of 64), and the
    shared memory of every tile and of every shipped plan."""
    from repro_torch.kernels.shgemm import TILES
    out: list[Finding] = []
    for bm, bn in TILES:
        for splits in (1, 2, 4):
            out.extend(audit_launches(
                module.launch_grid(2 * bm, 2 * bn, 256, bm, bn, 64, splits),
                what=f"{what} {(bm, bn, 64, splits)}"))
    entries = [(f"tile {t}", module.smem_bytes(*t)) for t in TILES]
    entries += [(f"shipped {key} {v['plan']}", module.smem_bytes(*v["plan"][:2]))
                for key, v in _shipped(suffix)]
    return out + audit_smem(entries, what=what)


def shgemm_audit(device="cpu") -> list[Finding]:
    from repro_torch.kernels import shgemm as k1
    return _gemm_audit(k1, "kernels/shgemm.py", ":mat")


def shgemm_fused_audit(device="cpu") -> list[Finding]:
    from repro_torch.kernels import shgemm_fused as k2
    return _gemm_audit(k2, "kernels/shgemm_fused.py", ":fused")


def flash_attention_audit(device="cpu") -> list[Finding]:
    """Every group size, causal and not, over a ragged 100 positions; the
    shared memory of every head size and dtype the kernel takes."""
    from repro_torch.kernels import flash_attention as k3
    out: list[Finding] = []
    b, kv, hd, s = 2, 2, 16, 100
    for g in k3.GROUPS:
        for causal in (True, False):
            out.extend(audit_launches(
                k3.launch_grid(b, s, g * kv, kv, hd, causal=causal),
                what=f"kernels/flash_attention.py G={g} causal={causal}"))
    entries = [(f"hd={hd} {dt}", k3.smem_bytes(hd, dt))
               for hd in k3.HEAD_DIMS for dt in k3.DTYPES]
    return out + audit_smem(entries, what="kernels/flash_attention.py")


def factored_decode_audit(device="cpu") -> list[Finding]:
    """The reference's shapes (B 2, KV 2, G 2, hd 8, r 4, S 256) at three
    clocks and mixes of compressed slots, P of 1, 3, 8 and the planner's;
    and the shared memory of every plan the planner returns for the ten
    architectures' (G, hd) at the repo's ranks, slot counts and cache
    lengths, and of the shipped plans."""
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.models.registry import ARCHS
    out: list[Finding] = []
    b, kvh, g, hd, r, s = 2, 2, 2, 8, 4, 256
    for write_pos, comp in ((s - 1, (0, 128)), (37, (16, 0)), (0, (0, 0))):
        for splits in (1, 3, 8, None):
            plan = k4.decode_plan(b, kvh, s, hd, r, g, splits=splits)
            out.extend(audit_launches(
                k4.launch_grid(b, kvh, hd, r, g, plan, write_pos, comp),
                what=f"kernels/factored_decode.py P={plan.splits} "
                     f"write_pos={write_pos} comp_len={comp}"))
    entries = []
    for cfg in ARCHS.values():
        g, hd, kvh = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.n_kv_heads
        for r in (4, 8, 16, 32):
            for kv_bytes in (2, 4):
                for slots in (1, 4, 8, 16):
                    for s in (2048, 8192, 32768, 524288):
                        desc = (f"{cfg.name} G={g} hd={hd} r={r} "
                                f"kv_bytes={kv_bytes} B={slots} S={s}")
                        try:
                            plan = k4.decode_plan(slots, kvh, s, hd, r, g,
                                                  kv_bytes=kv_bytes)
                        except ValueError as e:
                            out.append(Finding(
                                rule="CUDA-SMEM",
                                file="kernels/factored_decode.py", line=0,
                                message=f"the planner refuses {desc}: {e}",
                                hint="the planner must return a plan for "
                                     "every shape the archs serve",
                                match=f"planner:{desc}"))
                            continue
                        entries.append((f"{desc} P={plan.splits}",
                                        k4.smem_bytes(g, hd, r, plan.splits,
                                                      kv_bytes)))
    for key, v in _shipped(""):
        shape = re.search(r":fdec:.*:g(\d+):hd(\d+):r(\d+)$", key)
        if shape:
            g, hd, r = (int(x) for x in shape.groups())
            entries += [(f"shipped {key} P={v['splits']} kv_bytes={kv_bytes}",
                         k4.smem_bytes(g, hd, r, v["splits"], kv_bytes))
                        for kv_bytes in (2, 4)]
    return out + audit_smem(entries, what="kernels/factored_decode.py")


CONTRACTS: dict[str, Callable[..., list[Finding]]] = {
    "srht-no-gemm": srht_no_gemm,
    "sketch-dtype-flow": sketch_dtype_flow,
    "stream-update-dtype-flow": stream_update_dtype_flow,
    "sketch-determinism": sketch_determinism,
    "shgemm-audit": shgemm_audit,
    "shgemm-fused-audit": shgemm_fused_audit,
    "flash-attention-audit": flash_attention_audit,
    "factored-decode-audit": factored_decode_audit,
    "stream-b-weak-audit": stream_b_accumulation_weak_audit,
}


def run_repo_contracts(names: list[str] | None = None, *,
                       device="cpu") -> list[Finding]:
    """The catalog (or the ``names`` of it) with the dispatch-mode
    contracts' inputs on ``device``; a contract that cannot run is a
    ``CONTRACT-ERROR`` finding."""
    out: list[Finding] = []
    for name, contract in CONTRACTS.items():
        if names is not None and name not in names:
            continue
        try:
            out.extend(contract(device))
        except Exception as e:  # a contract that cannot run is a finding
            out.append(Finding(
                rule="CONTRACT-ERROR", file=name, line=0,
                message=f"contract {name!r} failed to run: {e!r}",
                hint="the entry point changed shape/signature — update the "
                     "contract in analysis/contracts.py"))
    return out
