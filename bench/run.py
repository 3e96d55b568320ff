"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload rsvd.fused --seed 7 --seconds 15 --trace 0

The cell, its configuration (``bench/configs/<name>.json``), its traffic
(``bench/traffic/<name>.json``) and the metrics it reports (each read by
``bench/metrics/<name>.py``) are found by name from ``BENCHMARK.json``.  A
run makes the configuration's input pool on the card from ``--seed``, warms
the cell's one shape up (the first run of a checkout builds the kernels
there), then drives the entry of ``repro_torch`` in a closed loop, one
client and a fresh key a call, for ``--seconds``.  A sample of the window's
calls, drawn from the seed, is compared with the plain reference
(``bench/reference.py``) once the window has closed.  ``--trace 1`` then
traces a block of calls (``bench/devtrace.py``) for the per-layer metrics;
so does ``--trace 0`` in a cell with an end-to-end metric read from the
device trace.
The last line of standard output is the result, as JSON; the numbers
compared are the last lines of standard error.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
CACHE = BENCH / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Fixed cache directories inside the checkout, and no user autotune
    cache: plans come from the program's shipped file or its planners."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(CACHE / "no_user_plans.json")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """The cell ``name`` of ``spec``, its configuration and its traffic."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(spec: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics ``cell`` reports: its end-to-end ones untraced, its
    per-layer ones traced; a metric with ``workloads`` only in those."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def program_entry(entry: str, config: dict, traffic: dict, device):
    """``call(key, x) -> outputs`` through the program's entry point: (U, s,
    V^T) or (core, factors)."""
    dtype = traffic.get("omega_dtype", "bfloat16")
    import torch
    omega_dtype = getattr(torch, dtype)
    method = traffic["method"]
    if entry == "rsvd":
        from repro_torch.core.rsvd import rsvd

        def call(key, a):
            return tuple(rsvd(key, a, config["rank"],
                              oversample=config["oversample"],
                              power_iters=traffic.get("power_iters", 0),
                              method=method, omega_dtype=omega_dtype,
                              device=device))
        return call
    if entry in ("rp_hosvd", "rp_sthosvd"):
        from bench.inputs import hosvd_ranks
        from repro_torch.core import hosvd
        fn = getattr(hosvd, entry)
        ranks = tuple(hosvd_ranks(config))

        def call(key, t):
            res = fn(key, t, ranks, method=method, omega_dtype=omega_dtype,
                     device=device)
            return res.core, tuple(res.factors)
        return call
    raise ValueError(f"unknown entry {entry!r}")


class Card:
    """Synchronize and memory peaks on the card; no-ops on the CPU, where
    the tests drive the harness."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0


def to_device(out, device):
    """``out`` (a tensor or nested tuples of them) on ``device``."""
    if isinstance(out, (tuple, list)):
        return tuple(to_device(o, device) for o in out)
    return out.to(device)


def run_window(card: Card, call, pool, seed: int, seconds: float,
               sample: int) -> dict:
    """The closed loop: call i runs on pool[i % len(pool)] with the key of
    (seed, i) and is synchronized before the next; a reservoir of
    ``sample`` calls, drawn from the seed, keeps its outputs, copied to the
    host once the call's latency is taken, so that they hold no memory of
    the card's."""
    from bench.lattice import call_key
    rng = random.Random(seed)
    kept, latencies, failed, first_error = [], [], 0, None
    card.sync()
    card.reset_peak()
    start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - start < seconds:
        key, x = call_key(seed, i), i % len(pool)
        t0 = time.perf_counter()
        try:
            out = call(key, pool[x])
            card.sync()
        except Exception:  # a failed call counts; the loop goes on
            failed += 1
            first_error = first_error or traceback.format_exc()
            out = None
        latencies.append(time.perf_counter() - t0)
        slot = len(kept) if len(kept) < sample else rng.randrange(i + 1)
        if out is not None and slot < sample:
            entry = (i, key, x, to_device(out, "cpu"))
            if slot == len(kept):
                kept.append(entry)
            else:
                kept[slot] = entry
        del out
        i += 1
    card.sync()
    end = time.perf_counter()
    return {"calls": i - failed, "attempted": i, "failed": failed,
            "seconds": end - start, "latencies_s": latencies,
            "peak_bytes": card.peak(), "kept": kept, "error": first_error}


def compare_sample(torch, entry: str, config: dict, traffic: dict, pool,
                   kept) -> list[dict]:
    """Each kept call's numbers against the plain reference, with TF32 off,
    one call at a time."""
    from bench import reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference.REFERENCES[entry]
    out = []
    for i, key, x, got in sorted(kept, key=lambda k: k[0]):
        want = ref(pool[x], key, traffic, config)
        got = to_device(got, pool[x].device)
        out.append({"call": i, **reference.compare(entry, pool[x], got, want)})
        del want
    return out


def checks(traffic: dict, compared: list[dict], window: dict) -> dict:
    """Each number compared (the largest over the compared calls) beside
    its limit."""
    out = {}
    for name, limit in traffic["limits"].items():
        vals = [c[name] for c in compared]
        ok = vals and all(math.isfinite(v) for v in vals)
        out[name] = {"value": max(vals) if ok else None, "limit": limit}
    out["failed_calls"] = {"value": window["failed"], "limit": 0}
    return out


def is_correct(result_checks: dict, compared: list[dict]) -> bool:
    return bool(compared) and all(
        c["limit"] is not None and c["value"] is not None
        and c["value"] <= c["limit"] for c in result_checks.values())


def build_kernels(names: list[str]) -> list[str]:
    """Load the program's kernel libraries ``names`` before the rest of
    set-up, so that their build (a checkout's first run only) is timed
    apart; the names that had to be built."""
    if not names:
        return []
    from repro_torch.kernels import _build
    missing = [n for n in names if not _build.library_path(n).is_file()]
    for name in names:
        _build.load(name)
    return missing


def run_cell(torch, device, spec: dict, cell: dict, config: dict,
             traffic: dict, *, seed: int, seconds: float, trace: bool,
             t_start: float = _T0) -> dict:
    """One run of ``cell``: set-up, window, optional trace, comparison.
    Returns the result line's fields and the context the readers saw."""
    from bench import inputs, readers
    from bench.lattice import call_key
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card(torch, device)
    entry = traffic["entry"]
    call = program_entry(entry, config, traffic, device)
    marks = {"start_s": time.perf_counter()}
    built = build_kernels(traffic.get("builds", []) if card.cuda else [])
    marks["build_s"] = time.perf_counter()
    pool = inputs.make_pool(config, seed, device)
    card.sync()
    marks["pool_s"] = time.perf_counter()
    for j in range(traffic["warmup"]):
        call(call_key(seed, 2**40 + j), pool[j % len(pool)])
    card.sync()
    marks["warmup_s"] = time.perf_counter()
    setup_s = marks["warmup_s"] - t_start
    setup_parts, prev = {}, t_start
    for name, t in marks.items():
        setup_parts[name], prev = t - prev, t
    setup_parts["built"] = built
    setup_peak = card.peak()

    window = run_window(card, call, pool, seed, seconds, traffic["sample"])
    if window["error"]:
        print(window["error"], file=sys.stderr)
    kept = window.pop("kept")
    traced = None
    # the traced block: for the per-layer metrics, and on the card in an
    # untraced run too where an end-to-end metric is read from the device
    if trace or card.cuda and any(
            m["source"] == "device_trace"
            for m in cell_metrics(spec, cell["name"], False)):
        from bench import devtrace
        calls = [lambda j=j: call(call_key(seed, 2**41 + j),
                                  pool[j % len(pool)])
                 for j in range(traffic["traced_calls"])]
        traced, reduce_s = devtrace.traced_calls(
            torch, calls, load_json(BENCH / "layers.json"))
        traced["decomps"] = len(calls)
        print(f"[trace] {traced['device_events']} device operations, "
              f"{traced['unmatched']} without a traced launch, reduced in "
              f"{reduce_s:.3f} s; layers {traced['layers']}", file=sys.stderr)
    if card.cuda:
        torch.cuda.empty_cache()
    compared = compare_sample(torch, entry, config, traffic, pool, kept)
    del kept
    ctx = {"cell": cell["name"], "entry": entry, "config": config,
           "traffic": traffic, "setup_s": setup_s, "window": window,
           "compared": compared, "trace": traced}
    metrics = {}
    for m in cell_metrics(spec, cell["name"], trace):
        value = readers.load(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result_checks = checks(traffic, compared, window)
    return {"correct": is_correct(result_checks, compared),
            "attempted": window["attempted"], "failed": window["failed"],
            "metrics": metrics, "setup_peak": setup_peak, "traced": traced,
            "setup_parts": setup_parts,
            "checks": result_checks, "ctx": ctx}


def card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def pin_to_one_cpu() -> None:
    """Run this process, and the threads it starts later (those CUDA
    starts with the card), on the last CPU it may use: one process with few
    threads, and no migration between cores in the window."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[-1]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    pin_to_one_cpu()
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = find_cell(spec, args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(torch, device, spec, cell, config, traffic, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3

    limit = card_limit()
    w = res["ctx"]["window"]
    parts = res["setup_parts"]
    print(f"[card] {limit}; {w['attempted']} calls in {w['seconds']:.3f} s, "
          f"setup {res['ctx']['setup_s']:.3f} s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items() if k != "built")
          + f"; built {parts['built']}", file=sys.stderr)
    for c in res["ctx"]["compared"]:
        print("[compare] " + " ".join(f"{k} {v:.6g}" for k, v in c.items()),
              file=sys.stderr)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": max(res["setup_peak"],
                                            w["peak_bytes"]),
                   "power_limit": limit}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device_info}
    if args.trace:
        t = res["traced"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["setup_parts"] = res["setup_parts"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
