"""The training launcher (port of ``repro/launch/train.py``): random
weights from a seed, the train step, the token pipeline and the
fault-tolerant loop (resume, retry, rollback, emergency save, straggler
watch), on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 4

Without ``--device`` it runs on the card and raises where there is none.
The reference's mesh (data x model over every device, sharded params,
``jax.distributed`` across hosts) waits for training across processes: a
``--model-parallel`` above 1 and a multi-host environment raise, naming
ROADMAP Queue 1 item 16g.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from repro_torch.configs.base import smoke_config
from repro_torch.data.pipeline import MemmapTokens, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.serve import init_weights
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.train.loop import LoopConfig, train

log = logging.getLogger("repro_torch.launch.train")

# what the reference reads to join a pod slice (jax.distributed.initialize)
MULTI_HOST_ENV = "JAX_COORDINATOR"
NOT_PORTED = "training across processes (ROADMAP Queue 1 item 16g) is not ported yet"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(R.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--data", default=None,
                    help="token .bin file (np.int32); default synthetic")
    ap.add_argument("--ckpt-dir", default="repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.model_parallel > 1:
        raise NotImplementedError(f"--model-parallel {args.model_parallel}: "
                                  + NOT_PORTED)
    if MULTI_HOST_ENV in os.environ:
        raise NotImplementedError(f"a multi-host environment "
                                  f"({MULTI_HOST_ENV} is set): " + NOT_PORTED)
    dev = resolve_device(args.device)
    cfg = R.get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    log.info("device %s | arch %s (%.1fM params)", dev, cfg.name,
             T.param_count(cfg) / 1e6)

    params = init_weights(cfg, seed=args.seed, device=dev)
    step = R.make_train_step(cfg, optimizer=args.optimizer, lr=args.lr,
                             micro_batches=args.micro_batches)
    opt_state = step.init_opt(params)
    if args.data:
        data = MemmapTokens(args.data, seq_len=args.seq,
                            global_batch=args.global_batch)
    else:
        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.global_batch, seed=args.seed)

    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    params, opt_state, hist = train(step, params, opt_state, data, lcfg)
    if hist:
        med = float(np.median([h["dt"] for h in hist]))
        toks = args.global_batch * args.seq / med
        log.info("done: loss %.4f -> %.4f | %.3fs/step | %.0f tok/s",
                 hist[0]["loss"], hist[-1]["loss"], med, toks)
    return hist


if __name__ == "__main__":
    main()
