"""GaLore-RSVD vs AdamW: the paper's technique as an optimizer feature.

Trains the same smoke LM twice and reports loss curves + optimizer-state
memory — the mixed-precision RSVD range finder (core/rsvd.py) runs inside
the GaLore update to refresh the low-rank gradient subspace.

    PYTHONPATH=src python -m repro_torch.examples.galore_training --steps 40 [--device cpu]

The reference's jitted step is an eager ``registry.make_train_step`` here.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.examples import add_common_args
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.optim import galore
from repro_torch.optim.optimizers import adamw


def run(cfg, params, data, tx, steps):
    step = R.make_train_step(cfg, optimizer=tx)
    state = step.init_opt(params)
    losses = []
    p = params
    for i in range(steps):
        p, state, metrics = step(p, state, data.batch(i))
        losses.append(float(metrics["loss"]))
    return losses, state


def state_bytes(state) -> int:
    """Bytes of every tensor in an optimizer state (nested dicts, tuples)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(state_bytes(v) for v in state)
    return 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.galore_training")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rank", type=int, default=16)
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # widen the smoke model so 2-D weights qualify for projection
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(d_model=128, d_ff=256)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8,
                       seed=args.seed)

    out = {}
    for name, tx in [
        ("adamw", adamw(3e-3)),
        (f"galore(r={args.rank})", galore.galore(3e-3, rank=args.rank,
                                                 refresh_every=10)),
    ]:
        losses, state = run(cfg, params, data, tx, args.steps)
        mb = state_bytes(state) / 1e6
        out[name] = {"losses": losses, "state_mb": mb}
        print(f"{name:16s} loss {losses[0]:.3f} -> {losses[-1]:.3f}   "
              f"opt-state {mb:.2f} MB")
    print("(GaLore keeps Adam moments in the rank-r subspace refreshed by")
    print(" the paper's mixed-precision RSVD range finder)")
    return out


if __name__ == "__main__":
    main()
