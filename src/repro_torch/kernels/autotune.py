"""Plan autotuner for kernels 1, 2 and 4, with a persistent JSON cache (port
of ``repro/kernels/autotune.py``).

The tunables are the card's, not the TPU's:

  * kernels 1 and 2 (``shgemm``, ``shgemm_fused``): ``(bm, bn, splits)`` at
    the planner's ``bk``.  ``bk`` stays ``ops._plan_blocks``' value, which
    depends on K alone, and the bits of both kernels depend on ``bk`` alone,
    so a tuned plan never changes a result: it is bit-identical to the
    planner's.  (The reference tunes ``(bm, bn, bk)``; its tuned ``bk``
    moves the result by about an ulp.)
  * kernel 4 (``factored_decode``): its split count P
    (``factored_decode.decode_plan(..., splits=)``).

Candidates are filtered by each kernel's shared memory against the card's
per-block limit (``SMEM_LIMIT``, in place of the reference's 16 MiB VMEM
budget), for kernel 1 on the card also by the CUDA occupancy calculator
(``shgemm.blocks_per_sm`` >= 1), for kernel 4 by ``decode_plan``'s check.
Each candidate is timed through the ``ops`` entry (kernel plus split-K
reduction, the work of the planner's plan): ``INNER`` calls captured in a
CUDA graph, CUDA events around its replay, the median of ``REPS`` replays
(the entry is host-bound at small shapes, where events around eager calls
would rank the host's launch cost, not the plan), and the winner is cached
in a JSON file keyed by ``(backend, M, N, K, dtype, terms, variant)``
(``cuda:4096x266x4096:bfloat16:t2:mat``) or, for kernel 4, by
``cuda:fdec:bkv{B*KV}:s{S}:g{G}:hd{hd}:r{r}``.

Entry points per kernel family, as in the reference:

  * ``pick_blocks`` / ``pick_decode_block``: cheap, called by the ``ops``
    wrappers on every call without ``blocks=`` / ``splits=``: a usable cache
    entry gives the tuned plan, a miss the planner's (``ops.shgemm_plan``,
    ``ops.fused_plan``, ``factored_decode.decode_plan``), without timing
    anything.  ``pick_decode_block`` returns P.  A pick is resolved once
    per shape and process, as the reference resolves it once per traced
    program, so a served call reads no file.  ``forget_picks`` drops every
    resolved pick; this process's own ``autotune_*`` writes drop those of
    kernels 1-2 (their plans never change the bits), not kernel 4's P (a
    CUDA graph captured around kernel 4 holds a workspace sized for P, so
    it must not change under the graph).  The user cache is parsed again
    only when its mtime or size changed.
  * ``autotune_blocks`` / ``autotune_decode_block``: run the sweep on a
    miss and persist the winner; a second call is a cache hit that times
    nothing.

Mode tags: a card run writes ``"compiled"``; the shipped file
(``autotune_default.json``, written by ``python -m
repro_torch.kernels.autotune --ship`` on the card) holds ``"shipped"``; a CPU
run, which times the plain versions, writes ``"plain"`` (the reference's
``"interpret"``).  Each entry records the ``device`` it was timed on
(``torch.cuda.get_device_name``).  A card run serves only ``compiled`` or
``shipped`` entries of its own device (``ops.SM_COUNT`` and ``decode_plan``
assume an H100 SXM's 132 SMs); a CPU run may serve any entry, as the plain
versions ignore the plan.  The user's file is consulted first, the shipped
one second.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/repro_torch/autotune.json``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import time
from typing import Callable, Sequence

import torch

from repro_torch._atomic_io import atomic_write_json
from repro_torch.device import resolve_device
from repro_torch.kernels import factored_decode as _fd
from repro_torch.kernels import shgemm as _k
from repro_torch.kernels import shgemm_fused as _kf

BACKEND = "cuda"
# Dynamic shared memory one block may take on an H100 (opted in above 48 KB).
SMEM_LIMIT = 227 * 1024
# Split counts swept beside the planner's for each (bm, bn) of shgemm.TILES.
SPLIT_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# Kernel 4's split counts swept beside the planner's.
DECODE_CANDIDATES = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64)
REPS = 5     # timed runs, the median kept
INNER = 10   # calls a timed run: a short kernel's time is not one launch's


def cache_path() -> str:
    return (os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
            or os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                            "autotune.json"))


# (path, mtime_ns, size) -> parsed cache: the file is parsed again only
# when it changed.
_cache_memo: dict = {}
# Picks resolved in this process: kernels 1-2's (pick_blocks' arguments ->
# plan) and kernel 4's ((key, kv_bytes, mode, device) -> P).
_block_picks: dict = {}
_decode_picks: dict = {}


def _load_cache(path: str) -> dict:
    """The parsed cache file (read-only: copy it before changing it)."""
    try:
        st = os.stat(path)
        memo_key = (path, st.st_mtime_ns, st.st_size)
        if memo_key not in _cache_memo:
            _cache_memo.clear()
            with open(path) as f:
                _cache_memo[memo_key] = json.load(f)
        return _cache_memo[memo_key]
    except (OSError, ValueError):
        return {}


def default_cache_path() -> str:
    """The shipped cache next to this module: H100 timings of the main
    path's shapes, tagged ``mode: "shipped"``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "autotune_default.json")


_shipped_memo: dict = {}


def _load_shipped() -> dict:
    if "cache" not in _shipped_memo:
        try:
            with open(default_cache_path()) as f:
                _shipped_memo["cache"] = json.load(f)
        except (OSError, ValueError):
            _shipped_memo["cache"] = {}
    return _shipped_memo["cache"]


def _save_cache(path: str, cache: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write_json(path, cache, sort_keys=True)
    _block_picks.clear()


def _device(device) -> torch.device:
    """The device a pick is for: ``None`` is CUDA, as for every entry point;
    a pick never raises for a missing card (it only reads the cache)."""
    return torch.device("cuda" if device is None else device)


@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_name(device=None) -> str:
    """The name entries record: the card's (``torch.cuda.get_device_name``),
    or ``"cpu"``."""
    dev = _device(device)
    if dev.type != "cuda":
        return "cpu"
    return _cuda_name(dev.index if dev.index is not None
                      else torch.cuda.current_device())


def timing_mode(device=None) -> str:
    """``"compiled"`` for a CUDA device (the kernels run), ``"plain"`` for
    the CPU (the plain versions run, which no plan changes)."""
    return "compiled" if _device(device).type == "cuda" else "plain"


def _entry_usable(entry: dict, mode: str, device: str) -> bool:
    """A plain run may serve any entry; a card run only a ``compiled`` or
    ``shipped`` entry timed on a card of its own name."""
    if mode == "plain":
        return True
    return (entry.get("mode") in ("compiled", "shipped")
            and entry.get("device") == device)


def _lookup(key: str, mode: str, device: str) -> dict | None:
    """User cache first, then the shipped cache; entries this run may not
    serve are passed over."""
    for cache in (_load_cache(cache_path()), _load_shipped()):
        hit = cache.get(key)
        if hit and _entry_usable(hit, mode, device):
            return hit
    return None


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cache_key(m: int, n: int, k: int, b_dtype, terms: int, fused: bool,
              backend: str = BACKEND) -> str:
    variant = "fused" if fused else "mat"
    return f"{backend}:{m}x{n}x{k}:{_dtype_name(b_dtype)}:t{terms}:{variant}"


def decode_cache_key(bkv: int, s: int, g: int, hd: int, r: int,
                     backend: str = BACKEND) -> str:
    """Key of kernel 4's P: the B·KV rows of its grid, the cache length
    ``s``, the query heads a kv head ``g``, ``hd`` and the factor rank
    ``r``, the fields P depends on."""
    return f"{backend}:fdec:bkv{bkv}:s{s}:g{g}:hd{hd}:r{r}"


def _round_up(x: int, align: int) -> int:
    return -(-x // align) * align


# --------------------------------------------------------------------------
# Kernels 1 and 2: (bm, bn, splits) at the planner's bk
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def planned_blocks(m: int, n: int, k: int, *, terms: int = 2,
                   fused: bool = False) -> tuple[int, int, int, int]:
    """The planner's (bm, bn, bk, splits): what a miss serves (a pure
    function of the shape, kept per shape: every untuned call reads it)."""
    from repro_torch.kernels import ops  # deferred: ops imports this module
    return ops.fused_plan(m, n, k) if fused else ops.shgemm_plan(m, n, k, terms)


def valid_plan(plan, m: int, n: int, k: int, *, terms: int = 2,
               fused: bool = False) -> bool:
    """Whether ``plan`` = (bm, bn, bk, splits) launches for this shape at
    the planner's bk: a cached entry that is not is never served."""
    try:
        bm, bn, bk, splits = (int(x) for x in plan)
    except (TypeError, ValueError):
        return False
    tiles = -(-k // bk) if bk > 0 else 0
    return (bk == planned_blocks(m, n, k, terms=terms, fused=fused)[2]
            and (bm, bn) in _k.TILES and 1 <= splits <= _k.MAX_SPLITS
            and tiles % splits == 0)


def candidate_blocks(m: int, n: int, k: int, *, terms: int = 2,
                     fused: bool = False, smem_budget: int | None = None,
                     blocks_per_sm: Callable[[int, int], int] | None = None
                     ) -> list[tuple[int, int, int, int]]:
    """(bm, bn, bk, splits) to sweep: each tile of ``shgemm.TILES`` no
    larger than the padded problem whose block fits ``smem_budget``
    (``SMEM_LIMIT``) and, where ``blocks_per_sm(bm, bn)`` is given (the
    occupancy calculator, on the card), of which an SM holds one; each with
    the ``SPLIT_CANDIDATES`` that divide the bk tiles of k, its own planned
    split count, and a workspace within ``ops.MAX_WORKSPACE_BYTES``.  The
    planner's plan is always a candidate."""
    from repro_torch.kernels import ops
    plan = planned_blocks(m, n, k, terms=terms, fused=fused)
    bk = plan[2]
    tiles = -(-k // bk)
    budget = SMEM_LIMIT if smem_budget is None else smem_budget
    smem = _kf.smem_bytes if fused else _k.smem_bytes
    per_sm = 1 if fused else ops.SHGEMM_PER_SM[terms]
    out = []
    for bm, bn in _k.TILES:
        if bm > _round_up(m, 32) or bn > _round_up(n, 32):
            continue
        if smem(bm, bn) > budget:
            continue
        if blocks_per_sm is not None and blocks_per_sm(bm, bn) < 1:
            continue
        own = ops.plan_splits(m, n, k, (bm, bn, bk), per_sm)
        work = _k.workspace_bytes(_round_up(m, bm), _round_up(n, bn),
                                  tiles * bk, bk, 2)
        for splits in sorted(set(SPLIT_CANDIDATES) | {own}):
            if splits > tiles or tiles % splits:
                continue
            if splits > 1 and work > ops.MAX_WORKSPACE_BYTES:
                continue
            out.append((bm, bn, bk, splits))
    if plan not in out:
        out.append(plan)
    return out


def pick_blocks(m: int, n: int, k: int, *, b_dtype=torch.bfloat16,
                terms: int = 2, fused: bool = False,
                device=None) -> tuple[int, int, int, int]:
    """The tuned (bm, bn, bk, splits) where this shape was tuned on this
    card (or is in the shipped cache for it), else the planner's.  Never
    times anything; resolved once per shape in a process.  ``device`` is
    where the kernel will run (``None``: CUDA)."""
    dev = _device(device)
    mode = timing_mode(dev)
    dname = device_name(dev) if mode == "compiled" else "cpu"
    memo = (m, n, k, b_dtype, terms, fused, mode, dname)
    if memo not in _block_picks:
        hit = _lookup(cache_key(m, n, k, b_dtype, terms, fused), mode, dname)
        if hit and valid_plan(hit.get("plan"), m, n, k, terms=terms, fused=fused):
            _block_picks[memo] = tuple(int(x) for x in hit["plan"])
        else:
            _block_picks[memo] = planned_blocks(m, n, k, terms=terms, fused=fused)
    return _block_picks[memo]


def median_ms(fn: Callable[[], object], device: torch.device,
              reps: int = REPS, inner: int = INNER) -> float:
    """Median time a call of ``fn`` over ``reps`` timed runs of ``inner``
    calls.  On the card the ``inner`` calls are captured in one CUDA graph
    (after two calls on the capture stream, so that nothing is allocated
    while captured) and timed by CUDA events around its replay: the device
    time of the kernel and its split-K reduction, without the host's launch
    cost, which would rank host time wherever the ``ops`` entry is
    host-bound.  On the CPU, the host clock after one warm-up call."""
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(inner):
                fn()
        graph.replay()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / inner)
        del graph
        return statistics.median(times)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def gemm_timer(m: int, n: int, k: int, b_dtype, terms: int, fused: bool,
                device: torch.device) -> Callable[..., float]:
    """The default timer of one sweep: random operands made once, each plan
    timed through ``ops.shgemm`` / ``ops.shgemm_fused`` with its blocks and
    split count given."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=device) / k ** 0.5
    b = (None if fused else
         torch.randn((k, n), generator=gen, device=device).to(b_dtype))

    def timer(m_, n_, k_, plan, b_dtype_, terms_, fused_) -> float:
        bm, bn, bk, splits = plan
        if fused:
            call = (lambda: ops.shgemm_fused(
                a, (0, 0), n, blocks=(bm, bn, bk), splits=splits,
                terms=terms, omega_dtype=b_dtype, device=device))
        else:
            call = (lambda: ops.shgemm(a, b, blocks=(bm, bn, bk),
                                       splits=splits, terms=terms,
                                       device=device))
        return median_ms(call, device)
    return timer


def autotune_blocks(m: int, n: int, k: int, *, b_dtype=torch.bfloat16,
                    terms: int = 2, fused: bool = False,
                    candidates: Sequence[tuple[int, int, int, int]] | None = None,
                    time_fn: Callable[..., float] | None = None,
                    cache_file: str | None = None, force: bool = False,
                    device=None) -> tuple[tuple[int, int, int, int], bool]:
    """Sweep the plans of one problem shape; returns ``(plan, from_cache)``
    with plan = (bm, bn, bk, splits).

    ``time_fn(m, n, k, plan, b_dtype, terms, fused) -> ms`` is injectable
    for tests; the default times the ``ops`` entry on ``device`` (``None``:
    CUDA).  The entry records the timing ``mode`` and ``device``, so a card
    never serves a CPU's or another card's winner.  A usable entry already
    in the file is a hit and times nothing (``force`` sweeps again)."""
    dev = resolve_device(device)
    mode, dname = timing_mode(dev), device_name(dev)
    path = cache_file or cache_path()
    ckey = cache_key(m, n, k, b_dtype, terms, fused)
    hit = _load_cache(path).get(ckey)
    if (not force and hit and _entry_usable(hit, mode, dname)
            and valid_plan(hit.get("plan"), m, n, k, terms=terms, fused=fused)):
        return tuple(int(x) for x in hit["plan"]), True

    if candidates is None:
        occupancy = None
        if mode == "compiled" and not fused:
            lowp = torch.float16 if b_dtype == torch.float16 else torch.bfloat16
            occupancy = (lambda bm, bn: _k.blocks_per_sm(bm, bn, terms, lowp,
                                                         device=dev))
        candidates = candidate_blocks(m, n, k, terms=terms, fused=fused,
                                      blocks_per_sm=occupancy)
    timer = time_fn or gemm_timer(m, n, k, b_dtype, terms, fused, dev)
    timings = {tuple(c): float(timer(m, n, k, tuple(c), b_dtype, terms, fused))
               for c in candidates}
    best = min(timings, key=timings.get)
    # re-read (another process may have written) and copy (the loader
    # memoizes the parsed dict: do not mutate it before the save lands)
    cache = dict(_load_cache(path))
    cache[ckey] = {
        "plan": list(best), "ms": timings[best], "mode": mode,
        "device": dname,
        "planned": list(planned_blocks(m, n, k, terms=terms, fused=fused)),
        "swept": {"x".join(map(str, c)): t for c, t in sorted(timings.items())},
    }
    _save_cache(path, cache)
    return best, False


# --------------------------------------------------------------------------
# Kernel 4: the split count P
# --------------------------------------------------------------------------

def planned_decode_block(b: int, kvh: int, s: int, g: int, hd: int, r: int,
                         *, kv_bytes: int = 2) -> int:
    """``decode_plan``'s P for these shapes: what a miss serves."""
    return _fd.decode_plan(b, kvh, s, hd, r, g, kv_bytes=kv_bytes).splits


def _decode_fits(p: int, g: int, hd: int, r: int, kv_bytes: int) -> bool:
    return _fd.smem_bytes(g, hd, r, p, kv_bytes) <= _fd.SMEM_LIMIT


def candidate_decode_blocks(b: int, kvh: int, s: int, g: int, hd: int,
                            r: int, *, kv_bytes: int = 2,
                            grain: int = _fd.GRAIN) -> list[int]:
    """P to sweep: ``DECODE_CANDIDATES`` and the planner's P, at most one
    split a grain of the cache, each within ``decode_plan``'s shared-memory
    limit."""
    planned = planned_decode_block(b, kvh, s, g, hd, r, kv_bytes=kv_bytes)
    most = -(-s // grain)
    out = [p for p in sorted(set(DECODE_CANDIDATES) | {planned})
           if p <= most and _decode_fits(p, g, hd, r, kv_bytes)]
    return out or [planned]


def forget_picks() -> None:
    """Forget every resolved pick: the next one reads the cache files again
    (kernel 4's only where no captured CUDA graph holds kernel 4)."""
    _block_picks.clear()
    _decode_picks.clear()


def pick_decode_block(b: int, kvh: int, s: int, g: int, hd: int, r: int, *,
                      kv_bytes: int = 2, device=None) -> int:
    """Kernel 4's P: the tuned one where this shape was tuned on this card
    (or is shipped for it) and fits the shared memory of this cache's
    element size, else ``decode_plan``'s.  Depends on the shapes alone and
    is resolved once per shape in a process."""
    dev = _device(device)
    mode = timing_mode(dev)
    dname = device_name(dev) if mode == "compiled" else "cpu"
    ckey = decode_cache_key(b * kvh, s, g, hd, r)
    memo = (ckey, kv_bytes, mode, dname)
    if memo not in _decode_picks:
        p = planned_decode_block(b, kvh, s, g, hd, r, kv_bytes=kv_bytes)
        hit = _lookup(ckey, mode, dname)
        if hit:
            tuned = hit.get("splits")
            if (isinstance(tuned, int) and tuned >= 1
                    and _decode_fits(tuned, g, hd, r, kv_bytes)):
                p = tuned
        _decode_picks[memo] = p
    return _decode_picks[memo]


def decode_timer(b: int, kvh: int, s: int, g: int, hd: int, r: int,
                  kv_bytes: int, device: torch.device) -> Callable[..., float]:
    """The default timer of one decode sweep: random state made once at
    the full slot (``write_pos = s - 1``, half of each slot factored),
    each P timed through ``ops.factored_decode_attention``."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(0)
    kv_dtype = torch.bfloat16 if kv_bytes == 2 else torch.float32

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    q = rnd(b, 1, g * kvh, hd, dtype=kv_dtype)
    k, v = rnd(b, s, kvh, hd, dtype=kv_dtype), rnd(b, s, kvh, hd, dtype=kv_dtype)
    k_us, v_us = rnd(b, kvh, s, r), rnd(b, kvh, s, r)
    k_vt, v_vt = rnd(b, kvh, r, hd), rnd(b, kvh, r, hd)
    comp = torch.full((b,), s // 2, dtype=torch.int32, device=device)

    def timer(b_, kvh_, s_, g_, hd_, r_, splits) -> float:
        return median_ms(lambda: ops.factored_decode_attention(
            q, k, v, k_us, k_vt, v_us, v_vt, comp, s - 1, scale=hd ** -0.5,
            splits=splits), device)
    return timer


def autotune_decode_block(b: int, kvh: int, s: int, g: int, hd: int, r: int,
                          *, kv_bytes: int = 2,
                          candidates: Sequence[int] | None = None,
                          time_fn: Callable[..., float] | None = None,
                          cache_file: str | None = None, force: bool = False,
                          device=None) -> tuple[int, bool]:
    """Sweep kernel 4's P for one decode shape; returns ``(P,
    from_cache)``.  ``time_fn(b, kvh, s, g, hd, r, P) -> ms`` is injectable
    for tests.  The persisted entry carries the timing ``mode`` and
    ``device``.  Picks already resolved in this process keep their P."""
    dev = resolve_device(device)
    mode, dname = timing_mode(dev), device_name(dev)
    path = cache_file or cache_path()
    ckey = decode_cache_key(b * kvh, s, g, hd, r)
    hit = _load_cache(path).get(ckey)
    if (not force and hit and _entry_usable(hit, mode, dname)
            and isinstance(hit.get("splits"), int)):
        return hit["splits"], True

    cands = (list(candidates) if candidates is not None else
             candidate_decode_blocks(b, kvh, s, g, hd, r, kv_bytes=kv_bytes))
    timer = time_fn or decode_timer(b, kvh, s, g, hd, r, kv_bytes, dev)
    timings = {int(p): float(timer(b, kvh, s, g, hd, r, int(p))) for p in cands}
    best = min(timings, key=timings.get)
    cache = dict(_load_cache(path))
    cache[ckey] = {
        "splits": best, "ms": timings[best], "mode": mode, "device": dname,
        "planned": planned_decode_block(b, kvh, s, g, hd, r,
                                        kv_bytes=kv_bytes),
        "swept": {str(p): t for p, t in sorted(timings.items())},
    }
    _save_cache(path, cache)
    return best, False


# --------------------------------------------------------------------------
# The shipped cache
# --------------------------------------------------------------------------

# The main path's shapes (m, n, k): rSVD's sketch (4096^2 @ . x 266) and
# RP-ST-HOSVD's three mode projections of 256^3 at ranks 32^3 (the first is
# RP-HOSVD's), for kernels 1 and 2 in bf16 with two terms.
SHIPPED_GEMM_SHAPES = ((4096, 266, 4096), (256, 32, 65536), (256, 32, 8192),
                       (256, 32, 1024))
# The serving engine's kernel-4 state (b, kvh, s, g, hd, r): qwen3-0.6b,
# 8 slots x 2048 rows, 16 query heads over 8 kv heads, rank-32 factors.
SHIPPED_DECODE_SHAPES = ((8, 8, 2048, 2, 128, 32),)


def ship(out_path: str | None = None, device=None, note: str = "") -> dict:
    """Sweep the shipped shapes on the card and write them as ``shipped``
    entries (``default_cache_path()`` unless ``out_path``).  Each entry
    keeps its timings, the card's name and ``note``."""
    import tempfile
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the shipped cache holds card timings only")
    with tempfile.TemporaryDirectory() as tmp:
        tuned = os.path.join(tmp, "autotune.json")
        for m, n, k in SHIPPED_GEMM_SHAPES:
            for fused in (False, True):
                autotune_blocks(m, n, k, fused=fused, cache_file=tuned,
                                force=True, device=dev)
        for shape in SHIPPED_DECODE_SHAPES:
            autotune_decode_block(*shape, cache_file=tuned, force=True,
                                  device=dev)
        with open(tuned) as f:
            doc = json.load(f)
    for entry in doc.values():
        entry["mode"] = "shipped"
        entry["note"] = note
    path = out_path or default_cache_path()
    atomic_write_json(path, doc, sort_keys=True)
    _shipped_memo.clear()
    _block_picks.clear()
    return doc


if __name__ == "__main__":
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(description=(
        "Write the shipped autotune cache: sweep the main path's shapes for "
        "kernels 1, 2 and 4 on the card."))
    ap.add_argument("--ship", action="store_true", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    doc = ship(args.out, note=(f"timed by python -m repro_torch.kernels."
                               f"autotune --ship on {card.splitlines()[0]}"))
    for key, entry in sorted(doc.items()):
        print(key, json.dumps({k: v for k, v in entry.items()
                               if k != "swept"}))
