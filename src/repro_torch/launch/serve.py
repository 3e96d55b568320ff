"""The serving slice end to end: whole-prompt prefill and the closed-loop
engine with incremental KV compression (port of the engine half of
``repro/launch/serve.py``), on random weights made from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

``chip_smoke.py`` calls ``run_prefill``, ``run_engine`` and ``lockstep`` at
qwen3-0.6b's full width; the CPU tests call them on the smoke config.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, Request


def init_weights(cfg: ModelCfg, *, seed: int = 0, device=None) -> dict:
    """Random f32 master weights at the schema's scales, from ``seed``."""
    dev = resolve_device(device)
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))


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


def run_prefill(cfg: ModelCfg, params: dict, tokens: torch.Tensor):
    """Whole-prompt prefill (``make_prefill_step``): (last-position logits
    (B, V) f32, the cache of every layer)."""
    return R.make_prefill_step(cfg)(params, {"tokens": tokens})


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


def main() -> None:
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
    ap.add_argument("--kv-compress-ratio", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = R.get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.with_(use_flash_kernel=True)    # wrappers pick by device
    dev = resolve_device(args.device)
    params = init_weights(cfg, seed=args.seed, device=dev)
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab,
                           seed=args.seed + 1)
    res = run_engine(cfg, params, prompts, max_new=args.max_new, device=dev,
                     slots=args.slots, max_seq=args.max_seq,
                     kv_sketch_rank=args.kv_rank,
                     kv_compress_ratio=args.kv_compress_ratio)
    rep = res["engine"].kv_bytes_report()
    print(f"served {args.requests} requests / {res['tokens']} tokens in "
          f"{res['seconds']:.3f} s ({res['tokens_per_s']:.1f} tok/s, "
          f"{res['steps']} steps) on {dev}; comp_len "
          f"{[int(c) for c in res['engine']._kv_comp_len]}; swappable KV "
          f"{rep['compressed_bytes']} B vs dense {rep['dense_bytes']} B")


if __name__ == "__main__":
    main()
