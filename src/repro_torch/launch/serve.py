"""The serving slice end to end (port of ``repro/launch/serve.py``), on
random weights made from a seed: whole-prompt prefill, the closed-loop
engine with incremental KV compression, and the open-loop continuous-
batching scheduler driven by a seeded Poisson trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch gemma2-2b --arrival-rate 50 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b

With ``--arrival-rate`` (or ``--load-trace``) the launcher drives the
scheduler (``serve/scheduler.py``): seeded arrivals from
``serve/loadgen.py`` (or a replayed trace file), bounded-queue admission,
chunked prefill interleaved with decode and an SLO table from
``serve/metrics.py`` (virtual-clock seconds), written as JSON with
``--report``; ``--save-trace`` stores the generated trace for replay.
``--hbm-budget`` caps the concurrent streams at what the budget holds at
worst case.  Without a rate or trace it runs the closed-loop engine.
Everything runs on the card unless ``--device cpu`` is given.

``chip_smoke.py`` calls ``run_prefill``, ``run_engine``, ``lockstep`` and
``run_scheduler`` at full width; the CPU tests call them on the smoke
configs.  whisper-large-v3's and llava-next-34b's stub frontends take
embeddings, which ``stub_embeds`` draws and ``run_prefill`` forwards; the
engine and the scheduler are text-only, as the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._atomic_io import atomic_write_json
from repro_torch.configs.base import ModelCfg, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import loadgen
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.metrics import format_slo_table
from repro_torch.serve.model_step import ModelStep
from repro_torch.serve.scheduler import Scheduler


def init_weights(cfg: ModelCfg, *, seed: int = 0, device=None,
                 compute_dtype: bool = False, mesh=None,
                 specs: dict | None = None) -> dict:
    """Random f32 master weights at the schema's scales, from ``seed``; with
    ``compute_dtype`` drawn straight into the activation dtype instead
    (``transformer.init_params``), which serving an MoE configuration needs:
    qwen3-moe-30b-a3b's f32 masters (122 GB) do not fit one card.

    With a bound ``mesh`` and ``specs`` (``sharding.rules.param_specs``)
    each rank replays the same draws and keeps its slice of each, bit for
    bit the slice of the one-process weights.  This helper is the port's
    own: the reference initialises the whole model and then shards it
    (``shard_params``), which at 61 GB does not fit beside a second rank on
    one card."""
    dev = resolve_device(device)
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         compute_dtype=compute_dtype, mesh=mesh, specs=specs)


def make_prompts(n: int, length: int, vocab: int, *, seed: int = 1) -> list[list[int]]:
    """``n`` equal-length prompts of random token ids.  Equal lengths keep
    every slot contiguous under the engine's uniform clock, so all of them
    compress."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, size=length)]
            for _ in range(n)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_prefill(cfg: ModelCfg, params: dict, tokens: torch.Tensor, *,
                img_embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None):
    """Whole-prompt prefill (``make_prefill_step``): (last-position logits
    (B, V) f32, the cache of every layer).  A VLM's image embeddings go
    before the text; an enc-dec's frame embeddings go through its encoder
    (``stub_embeds`` draws either)."""
    batch = {"tokens": tokens}
    if img_embeds is not None:
        batch["img_embeds"] = img_embeds
    if enc_embeds is not None:
        batch["enc_embeds"] = enc_embeds
    return R.make_prefill_step(cfg)(params, batch)


def stub_embeds(cfg: ModelCfg, batch: int, *, seed: int = 2,
                device=None) -> dict:
    """The stub frontends' inputs of ``cfg`` for ``batch`` requests, drawn
    as ``0.01 * N(0, 1)`` from a ``torch.Generator`` seeded with ``seed``,
    in the activation dtype: a VLM's ``img_embeds`` (B, num_image_tokens,
    D), an enc-dec's ``enc_embeds`` (B, enc_seq, D); empty for a text-only
    model."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {}
    if cfg.vlm is not None:
        shapes["img_embeds"] = (batch, cfg.vlm.num_image_tokens, cfg.d_model)
    if cfg.encdec is not None:
        shapes["enc_embeds"] = (batch, cfg.encdec.enc_seq, cfg.d_model)
    act = getattr(torch, cfg.activation_dtype)
    return {k: (0.01 * torch.randn(shape, generator=gen, device=dev)).to(act)
            for k, shape in shapes.items()}


def run_engine(cfg: ModelCfg, params: dict, prompts: list[list[int]], *,
               max_new: int, device=None, on_step=None, **engine_kw) -> dict:
    """Submit every prompt to an ``Engine(cfg, params, **engine_kw)`` and
    drain it, timing each step on the host clock ending in a synchronize.
    ``on_step(engine, i)``, if given, runs after step ``i`` outside that
    step's time (``chip_smoke.py`` traces a decode step there); ``seconds``
    spans the whole drain, hook included.  Returns the engine, the steps
    run here, their times (ms), the wall time and tokens/s."""
    dev = resolve_device(device)
    eng = Engine(cfg, params, device=dev, **engine_kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    _sync(dev)
    t0 = time.perf_counter()
    step_ms = []
    while eng.queue or any(eng.active):
        t1 = time.perf_counter()
        eng.step()
        _sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if on_step is not None:
            on_step(eng, len(step_ms) - 1)
    _sync(dev)
    seconds = time.perf_counter() - t0
    tokens = max_new * len(prompts)
    return {"engine": eng, "steps": len(step_ms), "step_ms": step_ms,
            "seconds": seconds, "tokens": tokens,
            "tokens_per_s": tokens / seconds}


def run_scheduler(cfg: ModelCfg, params: dict, trace: list, *,
                  max_queue: int = 1024, prefill_chunk: int = 8,
                  hbm_budget: int | None = None, device=None, on_step=None,
                  **model_kw) -> dict:
    """Open-loop run: replay ``trace`` (``loadgen.TraceRequest``s) through a
    ``Scheduler`` over ``ModelStep(cfg, params, **model_kw)`` on the
    virtual clock until it drains.  Each scheduler step is timed on the host
    clock ending in a synchronize, with the single-slot prefill calls and
    batched decode steps it ran (``step_kinds``: (prefill calls, decode
    steps)); ``on_step(scheduler, i)``, if given, runs after step ``i``
    outside its time.  Returns the scheduler, the step times, the wall
    time, the output tokens and tokens/s on the wall clock, and the
    virtual-clock SLO ``summary``."""
    dev = resolve_device(device)
    model = ModelStep(cfg, params, device=dev, **model_kw)
    sch = Scheduler(model, max_queue=max_queue, prefill_chunk=prefill_chunk,
                    hbm_budget=hbm_budget)
    calls = [0, 0]
    prefill_rows, decode_logits, step = (model.prefill_rows,
                                         model.decode_logits, sch.step)

    def counted(fn, i):
        def call(*a, **kw):
            calls[i] += 1
            return fn(*a, **kw)
        return call
    model.prefill_rows = counted(prefill_rows, 0)
    model.decode_logits = counted(decode_logits, 1)
    step_ms, kinds = [], []

    def timed_step() -> bool:
        before = list(calls)
        t1 = time.perf_counter()
        did = step()
        _sync(dev)
        if did:
            step_ms.append((time.perf_counter() - t1) * 1e3)
            kinds.append((calls[0] - before[0], calls[1] - before[1]))
            if on_step is not None:
                on_step(sch, len(step_ms) - 1)
        return did
    sch.step = timed_step
    _sync(dev)
    t0 = time.perf_counter()
    sch.run(trace)
    _sync(dev)
    seconds = time.perf_counter() - t0
    del sch.step, model.prefill_rows, model.decode_logits
    tokens = sum(len(r.out) for r in sch.finished)
    return {"scheduler": sch, "steps": len(step_ms), "step_ms": step_ms,
            "step_kinds": kinds, "seconds": seconds, "tokens": tokens,
            "tokens_per_s": tokens / seconds,
            "summary": sch.metrics.summary(expected=len(trace))}


def lockstep(engines: list[Engine], prompts: list[list[int]], *,
             max_new: int, seed: int = 0, max_steps: int = 10_000,
             compare=None) -> dict:
    """Drive engines in lockstep on identical token streams (teacher
    forcing): after every batched step each live slot's sampled token is
    overwritten with a shared pseudo-random one, so per-step logits stay
    comparable even where argmax would break a tie differently.  Returns
    the per-step max |logit - engines[0]'s| over live slots (``diffs``),
    max |logit| of engines[0] (``peaks``), ``compare(logits, engines[0]'s
    logits)`` of every other engine's live slots after every step
    (``compared``, when given), the decode step count and each engine's
    ``comp_len`` after every step."""
    vocab = engines[0].cfg.vocab
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new=max_new))
    forced = np.random.default_rng(seed).integers(0, vocab, size=max_steps + 1)
    diffs, peaks, compared = [], [], []
    comp_hist = [[] for _ in engines]
    step = 0
    while any(e.queue or any(e.active) for e in engines) and step < max_steps:
        counts = [e.step() for e in engines]
        if len(set(counts)) != 1:
            raise RuntimeError(f"engines fell out of lockstep: {counts}")
        live = [s for s in range(engines[0].slots)
                if engines[0].active[s] is not None]
        ref = engines[0].last_logits[live]
        peaks.append(float(ref.abs().max()) if ref.numel() else 0.0)
        for e in engines[1:]:
            got = e.last_logits[live]
            d = (got - ref).abs()
            diffs.append(float(d.max()) if d.numel() else 0.0)
            if compare is not None and got.numel():
                compared.append(compare(got, ref))
        for k, e in enumerate(engines):
            comp_hist[k].append([int(c) for c in e._kv_comp_len])
            for s in range(e.slots):
                if e.active[s] is not None and e.active[s].out:
                    e.active[s].out[-1] = int(forced[step])
        step += 1
    return {"diffs": diffs, "peaks": peaks, "compared": compared,
            "steps": step, "comp_len": comp_hist}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(R.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--kv-rank", type=int, default=32)
    ap.add_argument("--kv-compress-ratio", type=float, default=None,
                    help="swap a slot's dense KV rows for rank-r factors "
                         "once its dense tail reaches this many rows a rank "
                         "(default: sketch, never swap)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop load: generate a seeded Poisson trace "
                         "at this req/s and drive the scheduler")
    ap.add_argument("--load-trace", default=None,
                    help="replay a trace file saved by --save-trace "
                         "(overrides --arrival-rate/--requests)")
    ap.add_argument("--save-trace", default=None,
                    help="save the generated trace for later replay")
    ap.add_argument("--report", default=None,
                    help="write the SLO summary as JSON here")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="bounded request queue: past this depth submits "
                         "are rejected (backpressure)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prefill/catch-up token budget per scheduler step")
    ap.add_argument("--hbm-budget", type=int, default=None,
                    help="swappable-KV byte budget for compression-aware "
                         "admission (caps concurrent streams)")
    args = ap.parse_args(argv)
    cfg = R.get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.with_(use_flash_kernel=True)    # wrappers pick by device
    dev = resolve_device(args.device)
    # f32 masters of the MoE and VLM configs do not fit one card
    params = init_weights(cfg, seed=args.seed, device=dev,
                          compute_dtype=cfg.moe is not None or cfg.vlm is not None)
    model_kw = dict(slots=args.slots, max_seq=args.max_seq,
                    temperature=args.temperature, kv_sketch_rank=args.kv_rank,
                    kv_compress_ratio=args.kv_compress_ratio)
    if args.load_trace or args.arrival_rate is not None:
        _serve_trace(args, cfg, params, dev, model_kw)
        return
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab,
                           seed=args.seed + 1)
    res = run_engine(cfg, params, prompts, max_new=args.max_new, device=dev,
                     **model_kw)
    rep = res["engine"].kv_bytes_report()
    print(f"served {args.requests} requests / {res['tokens']} tokens in "
          f"{res['seconds']:.3f} s ({res['tokens_per_s']:.1f} tok/s, "
          f"{res['steps']} steps) on {dev}; comp_len "
          f"{[int(c) for c in res['engine']._kv_comp_len]}; swappable KV "
          f"{rep['compressed_bytes']} B vs dense {rep['dense_bytes']} B")


def _serve_trace(args, cfg: ModelCfg, params: dict, dev, model_kw: dict) -> None:
    """The CLI's open-loop run: the trace, ``run_scheduler``, the SLO table
    and the optional report."""
    if args.load_trace:
        trace = loadgen.load_trace(args.load_trace)
        what = f"replayed {len(trace)} requests from {args.load_trace}"
    else:
        trace = loadgen.generate_trace(args.seed, args.requests,
                                       args.arrival_rate, vocab=cfg.vocab)
        what = (f"generated {len(trace)} requests at {args.arrival_rate} "
                f"req/s (seed {args.seed})")
    if args.save_trace:
        loadgen.save_trace(trace, args.save_trace,
                           meta={"seed": args.seed, "arch": cfg.name,
                                 "arrival_rate": args.arrival_rate})
        what += f", saved to {args.save_trace}"
    res = run_scheduler(cfg, params, trace, max_queue=args.max_queue,
                        prefill_chunk=args.prefill_chunk,
                        hbm_budget=args.hbm_budget, device=dev, **model_kw)
    sch = res["scheduler"]
    print(f"{what}; drained in {res['seconds']:.3f} s wall on {dev} "
          f"({res['tokens']} tokens, {res['tokens_per_s']:.1f} tok/s, "
          f"{res['steps']} steps); admission cap {sch.max_streams} streams "
          f"(stream bound {sch.stream_bound} B"
          + (f", budget {args.hbm_budget} B)" if args.hbm_budget else ")"))
    print("SLO summary (virtual clock):")
    print(format_slo_table(res["summary"]))
    if args.report:
        atomic_write_json(args.report, {
            "config": {"arch": cfg.name, "slots": args.slots,
                       "max_seq": args.max_seq, "kv_rank": args.kv_rank,
                       "kv_compress_ratio": args.kv_compress_ratio,
                       "hbm_budget": args.hbm_budget,
                       "max_streams": sch.max_streams,
                       "prefill_chunk": args.prefill_chunk,
                       "max_queue": args.max_queue},
            "wall_s": res["seconds"], "summary": res["summary"]})
        print(f"report written to {args.report}")


if __name__ == "__main__":
    main()
