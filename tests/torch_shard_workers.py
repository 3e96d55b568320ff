"""Rank functions of the port's sharding tests (``test_torch_sharding.py``).

``repro_torch.launch.world.run_world`` imports this module in each rank's
process, so it imports no JAX: the reference's weights and batches reach
the ranks as numpy arrays in the keyword arguments.  Each function sets the
active mesh from ``sizes``, takes the global batch and its slices of the
whole weights, and returns numpy arrays (gathered whole where the test
compares whole leaves).
"""

import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.sharding import activation as A
from repro_torch.sharding import rules
from repro_torch.train import loop as loop_mod
from repro_torch.train.checkpoint import CheckpointManager

torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals


def smoke(arch: str, act: str):
    return smoke_config(R.get_arch(arch)).with_(activation_dtype=act)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _setup(sizes, cfg, *, specs=None):
    mesh = HostMesh(sizes).bind()
    specs = rules.param_specs(cfg, mesh) if specs is None else specs
    A.set_mesh(mesh)
    A.set_param_specs(specs)
    return mesh, specs


def _local(cfg, mesh, params, dev, specs):
    whole = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in params.items()}
    return rules.shard_params(cfg, mesh, whole, specs)


def loss_grads_case(rank, world, dev, *, sizes, arch, act, params, batch,
                    grads=True):
    """The global loss and the gathered gradients of the train step's
    ``loss_and_grads``."""
    cfg = smoke(arch, act)
    mesh, specs = _setup(sizes, cfg)
    local = _local(cfg, mesh, params, dev, specs)
    loss, g = R.loss_and_grads(cfg, local, batch)
    whole = rules.gather_params(cfg, mesh, g, specs) if grads else {}
    return float(loss), _np(whole) if rank == 0 else None


def forward_case(rank, world, dev, *, sizes, arch, act, params, tokens,
                 serving=False, flash=False):
    """The whole logits of a forward on the global ``tokens`` (gathered
    over the vocab and the batch), the prefill step's last-position logits
    and kernel 3's launches in them (``flash``: the kernel path)."""
    from repro_torch.kernels import flash_attention as k3
    cfg = smoke(arch, act).with_(use_flash_kernel=flash)
    specs = rules.param_specs(cfg, HostMesh(sizes), serving=serving)
    mesh, specs = _setup(sizes, cfg, specs=specs)
    local = _local(cfg, mesh, params, dev, specs)
    tok = torch.from_numpy(tokens).long().to(dev)
    with torch.no_grad():
        lg = T.forward(cfg, T.cast_params_for_compute(cfg, local), tok).logits
        lg = A.gather(lg, -1, mesh, "model")
        lg = A.global_rows(mesh, lg, tok.shape[0])
        k3.launches = 0
        last, _ = R.make_prefill_step(cfg)(local, {"tokens": tok})
    return {"logits": _np(lg.float()), "last": _np(last),
            "launches": k3.launches}


def _train_steps(cfg, mesh, specs, params, dev, batches, optimizer, lr):
    local = _local(cfg, mesh, params, dev, specs)
    step = R.make_train_step(cfg, optimizer=optimizer, lr=lr)
    opt = step.init_opt(local)
    metrics = []
    for b in batches:
        local, opt, m = step(local, opt, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    ospecs = rules.opt_state_specs(cfg, mesh, opt)
    state = {k: (rules.gather_params(cfg, mesh, v, ospecs[k])
                 if k in ("m", "v") else v)
             for k, v in opt.items()}
    return {"metrics": metrics,
            "params": _np(rules.gather_params(cfg, mesh, local, specs)),
            "opt": _np(state)}


def train_steps_case(rank, world, dev, *, sizes, arch, act, params, batches,
                     optimizers, lr=3e-4):
    """For each optimizer, ``len(batches)`` sharded train steps from
    ``params``: each step's loss and grad norm, the gathered params and
    the gathered optimizer state after them (rank 0's)."""
    cfg = smoke(arch, act)
    mesh, specs = _setup(sizes, cfg)
    out = {name: _train_steps(cfg, mesh, specs, params, dev, batches, name, lr)
           for name in optimizers}
    return out if rank == 0 else None


def moe_case(rank, world, dev, *, sizes, arch, act, params, batch, lr):
    """``forward_case`` and one AdamW step on ``batch``."""
    out = forward_case(rank, world, dev, sizes=sizes, arch=arch, act=act,
                       params=params, tokens=batch["tokens"])
    cfg = smoke(arch, act)
    out["step"] = _train_steps(cfg, A.get_mesh(), A.get_param_specs(), params,
                               dev, [batch], "adamw", lr)
    return out


def checkpoint_case(rank, world, dev, *, sizes, arch, params, one_dir,
                    ref_dir, out_dir):
    """Restore a one-process checkpoint and a reference checkpoint onto the
    mesh (each rank's slices against ``shard_params`` of the whole), then
    save the world's own (one step of AdamW on them) collectively."""
    cfg = smoke(arch, "float32")
    mesh, specs = _setup(sizes, cfg)
    whole = params_from_reference(params, cfg)
    want = rules.shard_params(cfg, mesh, whole, specs)
    template = {k: torch.empty(0) for k in params}
    out = {"roundtrip": all(torch.equal(a, whole[k]) for k, a in
                            rules.gather_params(cfg, mesh, want, specs).items())}
    for tag, d in (("one", one_dir), ("ref", ref_dir)):
        got, step = CheckpointManager(d, mesh=mesh).restore(
            template, mesh=mesh, specs=specs)
        out[tag] = (step, all(torch.equal(got[k], want[k]) and
                              got[k].shape == want[k].shape for k in want))
    step_fn = R.make_train_step(cfg)
    opt = step_fn.init_opt(want)
    new, opt, _ = step_fn(want, opt, {"tokens": np.ones((4, 8), np.int64),
                                      "labels": np.ones((4, 8), np.int64)})
    ospecs = rules.opt_state_specs(cfg, mesh, opt)
    mgr = CheckpointManager(out_dir, mesh=mesh)
    with _Traffic() as traffic:
        mgr.save(7, (new, opt), blocking=True, specs=(specs, ospecs))
    split = [(new[k], specs[k]) for k in new] + [
        (opt[s][k], ospecs[s][k]) for s in ("m", "v") for k in opt[s]]
    out["save_traffic"] = dict(traffic.counts, own=sum(
        x.numel() * x.element_size() for x, spec in split
        if A.split_axes(spec)))
    out["latest"] = mgr.latest_step()
    out["saved"] = _np(rules.gather_params(cfg, mesh, new, specs))
    out["m"] = _np(rules.gather_params(cfg, mesh, opt["m"], specs))
    return out


class _Traffic:
    """Inside ``with``: the bytes this rank hands to ``dist.gather`` and
    the number of calls to the other collectives that move data."""

    NAMES = ("gather", "all_gather", "all_reduce", "broadcast")

    def __enter__(self):
        self.counts = {"gather_bytes": 0, "others": 0}
        self.saved = {k: getattr(dist, k) for k in self.NAMES}

        def gather(t, *a, **kw):
            self.counts["gather_bytes"] += t.numel() * t.element_size()
            return self.saved["gather"](t, *a, **kw)

        def other(fn):
            def call(*a, **kw):
                self.counts["others"] += 1
                return fn(*a, **kw)
            return call

        dist.gather = gather
        for k in self.NAMES[1:]:
            setattr(dist, k, other(self.saved[k]))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(dist, k, fn)


def save_peak_case(rank, world, dev, *, sizes, arch):
    """A collective save of f32 masters and AdamW state on the card: the
    growth of this rank's peak device memory during the save, and its
    largest slice."""
    from repro_torch.launch.serve import init_weights
    cfg = smoke(arch, "float32")
    mesh, specs = _setup(sizes, cfg)
    params = init_weights(cfg, seed=0, device=dev, mesh=mesh, specs=specs)
    opt = R.make_train_step(cfg).init_opt(params)
    ospecs = rules.opt_state_specs(cfg, mesh, opt)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, mesh=mesh)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mgr.save(1, (params, opt), blocking=True, specs=(specs, ospecs))
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - before
        dist.barrier()
    A.set_mesh(None)
    return {"grew": grew, "largest": max(
        w.numel() * w.element_size() for w in params.values()),
        "state": sum(w.numel() * w.element_size() for w in params.values())}


def restore_case(rank, world, dev, *, sizes, arch, ckpt_dir, step):
    """Each rank's slice of a checkpoint, gathered back whole."""
    cfg = smoke(arch, "float32")
    mesh, specs = _setup(sizes, cfg)
    template = {k: torch.empty(0) for k in T.schema(cfg)}
    got, _ = CheckpointManager(ckpt_dir, mesh=mesh).restore(
        (template, None), step, mesh=mesh, specs=(specs, None))
    return _np(rules.gather_params(cfg, mesh, got[0], specs))


def remesh_case(rank, world, dev, *, arch, params):
    """4 ranks of (2, 2) -> ranks 0-1 of (2, 1) -> all 4 of (4, 1), each
    time gathered back whole."""
    cfg = smoke(arch, "float32")
    mesh, specs = _setup((2, 2), cfg)
    whole = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    local = rules.shard_params(cfg, mesh, whole, specs)

    def specs_fn(m):
        return rules.param_specs(cfg, m)

    out = {}
    small, placed = loop_mod.remesh(local, specs_fn, [0, 1], mesh=mesh)
    out["small"] = (small.shape, small.member)
    if small.member:
        out["small_whole"] = _np(rules.gather_params(cfg, small, placed,
                                                     specs_fn(small)))
    big, placed = loop_mod.remesh(placed, specs_fn, mesh=small,
                                  device=torch.device("cpu"))
    out["big"] = big.shape
    out["big_whole"] = _np(rules.gather_params(cfg, big, placed, specs_fn(big)))
    A.set_mesh(None)
    return out


def launcher_case(rank, world, dev, *, argv):
    """``launch.train.main`` inside the world."""
    from repro_torch.launch import train as launch_train
    return launch_train.main(argv)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def init_case(rank, world, dev, *, sizes, arch, compute_dtype, serving, seed):
    """This rank's ``init_weights(mesh=)`` slices (bf16 as int16 bits)."""
    from repro_torch.launch.serve import init_weights
    cfg = smoke_config(R.get_arch(arch))
    specs = rules.param_specs(cfg, HostMesh(sizes), serving=serving)
    mesh, specs = _setup(sizes, cfg, specs=specs)
    w = init_weights(cfg, seed=seed, device=dev, compute_dtype=compute_dtype,
                     mesh=mesh, specs=specs)
    return {"index": (mesh.index("data"), mesh.index("model")),
            "specs": specs, "w": {k: _bits(v) for k, v in w.items()}}


def gloo_dtypes_case(rank, world, dev):
    """all_reduce and all_gather of bf16 and f32 tensors on ``dev``."""
    import torch.distributed as dist
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.full((5,), 1.5 + rank, dtype=dt, device=dev)
        y = x.clone()
        dist.all_reduce(y)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        out[str(dt)] = (_bits(y.float()), [_bits(p.float()) for p in parts])
    return out


def loop_faults_case(rank, world, dev, *, sizes, ckpt_dirs):
    """``train(mesh=)`` with a step that fails after its collectives on one
    rank: once at step 2 (a retry), then at every attempt of step 3 (a
    rollback to step 2's checkpoint, after which it passes); and the same
    run with no fault.  What every rank saw, and the final params of both
    runs gathered."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import init_weights
    from repro_torch.train.loop import LoopConfig, train

    cfg = smoke("qwen3-0.6b", "float32")
    mesh, specs = _setup(sizes, cfg)
    step = R.make_train_step(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4)
    calls = {}

    def faulty(p, o, b):
        out = step(p, o, b)
        i = int(o["t"])
        calls[i] = calls.get(i, 0) + 1
        if (i == 1 and calls[i] == 1 and rank == world - 1) or \
                (i == 2 and calls[i] <= 3 and rank == 0):
            raise RuntimeError(f"fault at step {i + 1} on rank {rank}")
        return out

    out = {}
    for name, fn, d in (("faulty", faulty, ckpt_dirs[0]),
                        ("clean", step, ckpt_dirs[1])):
        params = init_weights(cfg, seed=0, device=dev, mesh=mesh, specs=specs)
        opt = step.init_opt(params)
        tree_specs = (specs, rules.opt_state_specs(cfg, mesh, opt))
        params, opt, hist, st = train(
            fn, params, opt, data,
            LoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=d, max_retries=2),
            mesh=mesh, specs=tree_specs, return_state=True)
        out[name] = {"steps": [h["step"] for h in hist],
                     "losses": [h["loss"] for h in hist],
                     "retries": st.retries, "rollbacks": st.rollbacks,
                     "params": _np(rules.gather_params(cfg, mesh, params, specs))}
    return out
