"""End-to-end training driver: any assigned arch, synthetic data,
fault-tolerant loop.

    # tiny run (CI / laptop):
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny --steps 30

    # ~100M-param run, a few hundred steps:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300

    # any assigned architecture at smoke scale:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma2-2b --steps 20

Checkpoints go to ``--ckpt-dir`` (a ``repro_torch_train_lm`` directory
under the temporary directory by default); a second run resumes there.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.configs.base import smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.examples import add_common_args
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.train.loop import LoopConfig, train


def preset_100m():
    """~100M-param dense LM (qwen3-family shape)."""
    return R.get_arch("qwen3-0.6b").with_(
        n_layers=8, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32000, attn_chunk=256)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--preset", choices=["tiny", "100m", "arch"],
                    default="tiny")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    if args.preset == "100m":
        cfg = preset_100m()
    else:
        cfg = smoke_config(R.get_arch(args.arch))

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    n = T.param_count(cfg)
    print(f"arch={cfg.name} params={n / 1e6:.1f}M "
          f"(active {T.active_param_count(cfg) / 1e6:.1f}M)")

    step = R.make_train_step(cfg, optimizer=args.optimizer, lr=args.lr)
    opt = step.init_opt(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)

    lcfg = LoopConfig(total_steps=args.steps,
                      ckpt_every=max(10, args.steps // 5),
                      ckpt_dir=args.ckpt_dir, log_every=5)
    params, opt, hist = train(step, params, opt, data, lcfg)
    losses = [h["loss"] for h in hist]
    median_dt = sorted(h["dt"] for h in hist)[len(hist) // 2]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(hist)} steps, median {median_dt:.3f}s/step)")
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not decrease")
    return {"arch": cfg.name, "params": n, "losses": losses,
            "median_step_s": median_dt}


if __name__ == "__main__":
    main()
