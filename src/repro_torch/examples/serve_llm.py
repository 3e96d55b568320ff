"""Batched serving demo: continuous batching over slots with KV caches.

    PYTHONPATH=src python -m repro_torch.examples.serve_llm --arch qwen3-0.6b --requests 6

Open-loop load (scheduler path, DESIGN.md §15): add ``--arrival-rate 200``
for seeded Poisson arrivals through serve/scheduler.py — chunked prefill,
bounded queue, catch-up admission — with the SLO summary table printed at
the end (``--report out.json`` writes it as JSON, ``--load-trace`` replays
a saved trace byte-for-byte).

Compressed-attention variant (DESIGN.md §12): add ``--kv-rank 4
--kv-compress-ratio 2`` and the engine swaps each slot's dense KV prefix for
rank-4 factors once it holds 8+ uncompressed rows, attending through the
factors from then on; the summary line reports the per-slot HBM savings.

The model is the architecture's smoke config, as in the reference, whose
``use_flash_kernel`` is off: attention runs the plain path (kernels 3 and 4
are the serving CLI's, ``repro_torch.launch.serve``).  ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch._atomic_io import atomic_write_json
from repro_torch.configs.base import smoke_config
from repro_torch.device import resolve_device
from repro_torch.examples import add_common_args
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import loadgen
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.metrics import format_slo_table
from repro_torch.serve.model_step import ModelStep
from repro_torch.serve.scheduler import Scheduler


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_scheduler(args, cfg, params, dev) -> dict:
    model = ModelStep(cfg, params, slots=args.slots, max_seq=128,
                      kv_sketch_rank=args.kv_rank,
                      kv_compress_ratio=args.kv_compress_ratio, device=dev)
    sch = Scheduler(model, max_queue=args.max_queue,
                    prefill_chunk=args.prefill_chunk)
    if args.load_trace:
        trace = loadgen.load_trace(args.load_trace)
    else:
        trace = loadgen.generate_trace(args.seed, args.requests,
                                       args.arrival_rate, vocab=cfg.vocab)
    t0 = time.perf_counter()
    sch.run(trace)
    _sync(dev)
    wall = time.perf_counter() - t0
    summary = sch.metrics.summary(expected=len(trace))
    print(f"arch={cfg.name} slots={args.slots}: scheduler drained "
          f"{len(trace)} requests in {wall:.2f}s wall")
    print("SLO summary (virtual-clock):")
    print(format_slo_table(summary))
    for q in sch.finished[:4]:
        print(f"  req{q.rid}: prompt[:4]={q.prompt[:4]} -> out={q.out}")
    if args.report:
        atomic_write_json(args.report, {"wall_s": wall, "summary": summary})
        print(f"report -> {args.report}")
    return {"path": "scheduler", "requests": len(trace), "wall_s": wall,
            "summary": summary,
            "outputs": {q.rid: list(q.out) for q in sch.finished}}


def run_engine(args, cfg, params, dev) -> dict:
    eng = Engine(cfg, params, slots=args.slots, max_seq=128,
                 kv_sketch_rank=args.kv_rank,
                 kv_compress_ratio=args.kv_compress_ratio, device=dev)

    reqs = [Request(rid=i, prompt=[1 + i, 2 + i, 3], max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)

    t0 = time.perf_counter()
    steps = 0
    while eng.queue or any(eng.active):
        eng.step()
        steps += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"arch={cfg.name} slots={args.slots}: {len(reqs)} requests, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {steps} engine steps)")
    kv_slots = []
    if eng.kv_fact is not None:
        kv_slots = eng.kv_bytes_report()["slots"]
        for r in kv_slots:
            print(f"  slot{r['slot']}: comp_len={r['comp_len']}/{r['pos']} "
                  f"HBM {r['compressed_bytes']} B vs dense "
                  f"{r['dense_bytes']} B ({r['ratio']:.2f}x)")
    for r in reqs:
        print(f"  req{r.rid}: prompt={r.prompt} -> out={r.out}")
    return {"path": "engine", "requests": len(reqs), "tokens": total_tokens,
            "wall_s": dt, "steps": steps, "kv_slots": kv_slots,
            "outputs": {r.rid: list(r.out) for r in reqs}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_llm")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--kv-rank", type=int, default=None)
    ap.add_argument("--kv-compress-ratio", type=float, default=None)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="drive the scheduler with Poisson arrivals (req/s)")
    ap.add_argument("--load-trace", default=None,
                    help="replay a saved loadgen trace file")
    ap.add_argument("--report", default=None,
                    help="write the SLO summary as JSON")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=6)
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(R.get_arch(args.arch))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    if args.load_trace or args.arrival_rate is not None:
        return run_scheduler(args, cfg, params, dev)
    return run_engine(args, cfg, params, dev)


if __name__ == "__main__":
    main()
