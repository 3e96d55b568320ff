"""The training launcher (port of ``repro/launch/train.py``): random
weights from a seed, the train step, the token pipeline and the
fault-tolerant loop (resume, retry, rollback, emergency save, straggler
watch), on one card or across processes.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 4
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --smoke --model-parallel 2

Without ``--device`` it runs on the card and raises where there is none.

Across processes (one process a device): inside a ``torch.distributed``
world that is already up (``launch.world.run_world``) it uses that world;
where ``torchrun`` describes one (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``: the counterpart of the reference's
``JAX_COORDINATOR``) it joins it, with ``nccl`` where each local rank has
a card of its own and ``gloo`` otherwise (and on the CPU).  The (data,
model) mesh is ``make_host_mesh(--model-parallel)`` (1 where that does not
divide the world, as the reference's ``build_mesh``); the params and the
optimizer state are each rank's slices (``sharding.rules``), drawn as the
one-process run draws them.  Each data rank reads its own rows of every
batch (``host_id`` = its data index, so the ranks of one model line read
the same rows; the reference takes ``jax.process_index()``, one host
holding many devices) and the data axis puts the global batch together,
which the train step takes.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import smoke_config
from repro_torch.data.pipeline import MemmapTokens, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import init_weights
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.sharding import activation as A
from repro_torch.sharding import rules
from repro_torch.train.loop import LoopConfig, train

log = logging.getLogger("repro_torch.launch.train")

# what torchrun sets for each process (the reference reads JAX_COORDINATOR)
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


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


def join_world(dev: torch.device) -> tuple[torch.device, bool]:
    """Join the world ``torchrun`` describes, unless one is up already or
    none is described: this rank's device (its own card where each local
    rank has one) and whether this call joined."""
    if dist.is_initialized() or not all(k in os.environ for k in LAUNCH_ENV):
        return dev, False
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    own_card = dev.type == "cuda" and torch.cuda.device_count() >= local
    if own_card:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method="env://")
    return dev, True


class GlobalBatches:
    """Each data rank reads its rows of a batch (``data`` sharded by
    host); the data axis gathers them into the global batch."""

    def __init__(self, data, mesh, device):
        self.data, self.mesh, self.device = data, mesh, device

    def batch(self, step: int) -> dict:
        return {k: A.gather(torch.as_tensor(v).to(self.device), 0, self.mesh,
                            "data")
                for k, v in self.data.batch(step).items()}


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    dev, joined = join_world(resolve_device(args.device))
    cfg = R.get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)

    mesh = make_host_mesh(args.model_parallel)
    specs = host_id = None
    n_hosts = 1
    if mesh.bound:
        specs = rules.param_specs(cfg, mesh)
        A.set_mesh(mesh)
        A.set_param_specs(specs)
        host_id, n_hosts = mesh.index("data"), mesh.size("data")
        log.info("mesh %s | rank %d | backend %s | arch %s (%.1fM params)",
                 mesh.shape, dist.get_rank(), dist.get_backend(), cfg.name,
                 T.param_count(cfg) / 1e6)
    else:
        log.info("device %s | arch %s (%.1fM params)", dev, cfg.name,
                 T.param_count(cfg) / 1e6)

    params = init_weights(cfg, seed=args.seed, device=dev,
                          mesh=mesh if mesh.bound else None, specs=specs)
    step = R.make_train_step(cfg, optimizer=args.optimizer, lr=args.lr,
                             micro_batches=args.micro_batches)
    opt_state = step.init_opt(params)
    host = dict(host_id=host_id or 0, num_hosts=n_hosts)
    if args.data:
        data = MemmapTokens(args.data, seq_len=args.seq,
                            global_batch=args.global_batch, **host)
    else:
        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.global_batch, seed=args.seed,
                           **host)

    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    try:
        if mesh.bound:
            tree_specs = (specs, rules.opt_state_specs(cfg, mesh, opt_state))
            params, opt_state, hist = train(
                step, params, opt_state, GlobalBatches(data, mesh, dev), lcfg,
                mesh=mesh, specs=tree_specs)
        else:
            params, opt_state, hist = train(step, params, opt_state, data, lcfg)
    finally:
        if mesh.bound:
            A.set_mesh(None)
            A.set_param_specs(None)
        if joined:
            dist.destroy_process_group()
    if hist:
        med = float(np.median([h["dt"] for h in hist]))
        toks = args.global_batch * args.seq / med
        log.info("done: loss %.4f -> %.4f | %.3fs/step | %.0f tok/s",
                 hist[0]["loss"], hist[-1]["loss"], med, toks)
    return hist


if __name__ == "__main__":
    main()
