"""Arch registry, the train step and the serving steps (port of
``repro/models/registry.py``).

``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` return
plain functions; PyTorch runs them eagerly, so there is nothing to jit.
``input_specs(cfg, shape)`` gives every model input of a shape cell as a
meta tensor (the dry run, ``launch/dryrun.py``, makes its fake tensors from
them); ``materialize_inputs`` draws concrete ones of the same tree, shapes
and dtypes; ``step_for`` picks the cell's step.
"""

from __future__ import annotations

import zlib
from typing import Callable

import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, ShapeCfg, shapes_for, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer as T
from repro_torch.models.layers import softcap
from repro_torch.optim import optimizers as opt_mod
from repro_torch.sharding import activation as A


def get_arch(name: str) -> ModelCfg:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


# ---------------------------------------------------------------------------
# Input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict:
    """The inputs of one (arch x shape) cell as meta tensors: the
    reference's keys, shapes and dtypes (int32 ids, bf16 stub embeddings;
    decode's one new token, its seq_len cache and a scalar ``write_pos``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        text = s - (cfg.vlm.num_image_tokens if cfg.vlm else 0)
        specs = {"tokens": _meta((b, text), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, text), torch.int32)
        if cfg.vlm:
            specs["img_embeds"] = _meta((b, cfg.vlm.num_image_tokens,
                                         cfg.d_model), torch.bfloat16)
        if cfg.encdec:
            specs["enc_embeds"] = _meta((b, cfg.encdec.enc_seq, cfg.d_model),
                                        torch.bfloat16)
        return specs
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": cache_mod.abstract_cache(cfg, b, s),
            "write_pos": _meta((), torch.int32)}


def _map_leaves(fn, tree, path=()):
    """``fn(name, leaf)`` over a tree of dicts and tuples, ``name`` the
    leaf's path joined by ``/`` (the reference's key path: dict keys and
    sequence indices); None stays None."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(str(p) for p in path), tree)


def materialize_inputs(cfg: ModelCfg, shape: ShapeCfg, seed: int, *,
                       device=None) -> dict:
    """Concrete random inputs matching ``input_specs``, on the card unless
    ``device="cpu"``.  Each leaf draws from its own ``torch.Generator``
    seeded from ``seed`` and ``zlib.crc32`` of its path, as the reference
    folds the crc into its key: ids uniform in [0, vocab), ``write_pos`` =
    seq_len - 1, floats 0.01 * N(0, 1) in the leaf's dtype.  These are not
    the reference's threefry draws."""
    dev = resolve_device(device)

    def make(name, spec):
        gen = torch.Generator(device=dev).manual_seed(
            (int(seed) << 31) + zlib.crc32(name.encode()) % 2**31)
        if spec.dtype == torch.int32:
            if "write_pos" in name:
                return torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                    device=dev)
            return torch.randint(0, cfg.vocab, tuple(spec.shape),
                                 generator=gen, dtype=torch.int32, device=dev)
        x = torch.randn(tuple(spec.shape), generator=gen, device=dev)
        return 0.01 * x.to(spec.dtype)

    return _map_leaves(make, input_specs(cfg, shape))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelCfg, optimizer="adamw", lr: float = 3e-4,
                    micro_batches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    metrics ``{"loss", "grad_norm"}`` (f32 scalar tensors).

    ``optimizer`` is a name of ``optim.optimizers.get`` (the reference's
    ``adamw | adafactor | sgd``) or an ``Optimizer`` (``optim.galore``'s,
    or one that compresses the gradients first).  ``batch`` holds
    ``tokens`` and ``labels`` (B, S), tensors or numpy arrays, and a VLM's
    ``img_embeds`` or an enc-dec's ``enc_embeds`` (B, N, D); they go to the
    params' device, the ids as integers, the embeddings in the activation
    dtype.  Autograd takes the place of ``jax.value_and_grad``:
    the f32 masters are cast for compute once a step, and
    ``micro_batches > 1`` splits the batch, runs one backward a microbatch
    (one microbatch of activations alive at a time), sums the cast
    weights' gradients in their dtype and averages the loss, as the
    reference's scan does.  Nothing is updated in place: new params and
    state are returned.

    Kernel 3 has no backward in either package, so a configuration with
    ``use_flash_kernel`` set is refused.

    Under an active mesh (``sharding.activation``) every rank passes the
    global batch and its slices of the params and state (stored as
    ``transformer.stored_specs``): the loss is the global masked mean, the
    gradients of the gathered compute copies go back through
    ``activation.reduce_grad`` (summed over the batch axes) in f32, a leaf
    held whole on every batch rank has its gradient all-reduced over them,
    and ``grad_norm`` counts each element of the global gradient once."""
    if cfg.use_flash_kernel:
        raise ValueError("the flash-attention kernel has no backward: train "
                         "with use_flash_kernel=False (the reference's "
                         "training default)")
    tx = opt_mod.get(optimizer, lr) if isinstance(optimizer, str) else optimizer

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, micro_batches)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = {k: params[k] + updates[k] for k in params}
        gnorm = torch.sqrt(_sq_norm(cfg, A.get_mesh(), grads))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    def init_opt(params):
        return tx.init(params)

    step.init_opt = init_opt
    return step


def loss_and_grads(cfg: ModelCfg, params: dict, batch: dict,
                   micro_batches: int = 1) -> tuple[torch.Tensor, dict]:
    """The train step's loss (an f32 scalar) and the gradient of every
    param in its dtype (``make_train_step``); under a mesh the loss is the
    global one and each gradient this rank's slice of the global one."""
    dev = next(iter(params.values())).device
    act = getattr(torch, cfg.activation_dtype)
    batch = {k: torch.as_tensor(v).to(dev, torch.long if k in ("tokens", "labels")
                                      else act)
             for k, v in batch.items()
             if k in ("tokens", "labels", "img_embeds", "enc_embeds")}
    b = batch["tokens"].shape[0]
    if b % micro_batches:
        raise ValueError(f"batch {b} does not split into {micro_batches} "
                         f"microbatches")
    # the cast copies are the leaves autograd differentiates; their
    # gradients cross the cast to the masters' dtype at the end, as the
    # reference's cotangents do
    mesh = A.get_mesh()
    with torch.no_grad():
        cast = T.cast_params_for_compute(cfg, params)
    leaves = {k: w.detach().requires_grad_() for k, w in cast.items()}
    names = sorted(leaves)
    inputs = [leaves[k] for k in names]
    acc, total = None, None
    for j in range(micro_batches):
        mb = {k: v.chunk(micro_batches)[j] for k, v in batch.items()}
        loss = T.loss_fn(cfg, leaves, mb)
        gs = torch.autograd.grad(loss / micro_batches, inputs,
                                 allow_unused=True, materialize_grads=True)
        acc = list(gs) if acc is None else [a + g for a, g in zip(acc, gs)]
        loss = loss.detach()
        total = loss if total is None else total + loss
    grads = {k: g.to(params[k].dtype) for k, g in zip(names, acc)}
    del acc, leaves, inputs, cast
    if mesh is not None:
        grads = _reduce_grads(cfg, mesh, grads)
    return total / micro_batches, grads


def _reduce_grads(cfg, mesh, grads: dict) -> dict:
    """Each gradient of a gathered compute copy, as its stored slice's
    (``activation.reduce_grad``), then summed over the batch axes where the
    leaf is whole on every batch rank."""
    specs = T.stored_specs(cfg, mesh)
    ba = A.batch_axes_of(mesh)
    out = {}
    for k, g in grads.items():
        spec = T.compute_spec(k, specs[k])
        g = A.reduce_grad(g, spec, mesh)
        if ba and not A.split_axes(spec) & set(ba):
            g = A.all_reduce(g, mesh, ba)
        out[k] = g
    return out


def _sq_norm(cfg, mesh, grads: dict) -> torch.Tensor:
    """|g|^2 of the whole gradient.  Under a mesh each rank adds the
    slices it is the first holder of, and one all-reduce sums the ranks."""
    if mesh is None:
        return sum(torch.vdot(g.reshape(-1), g.reshape(-1))
                   for _, g in sorted(grads.items()))
    specs = T.stored_specs(cfg, mesh)
    sq = torch.zeros((), dtype=torch.float32,
                     device=next(iter(grads.values())).device)
    for k, g in sorted(grads.items()):
        split = A.split_axes(specs[k])
        if all(mesh.index(a) == 0 for a in mesh.axis_names if a not in split):
            sq = sq + torch.vdot(g.reshape(-1), g.reshape(-1)).float()
    return A.all_reduce(sq, mesh, mesh.axis_names)


def _final_logits(cfg, logits: torch.Tensor) -> torch.Tensor:
    """Serving consumers get f32 + the final softcap."""
    return softcap(logits.float(), cfg.final_softcap)


def make_prefill_step(cfg: ModelCfg) -> Callable:
    """(params, batch{tokens[, img_embeds][, enc_embeds]}) -> (last_logits
    (B, V) f32, cache).

    Logits are computed at the last position only (``forward(last_only=
    True)``): the step returns no other, and the full (B, S, V) logits at
    S = 32768 would be 10 GB."""

    def step(params, batch):
        p = T.cast_params_for_compute(cfg, params)
        out = T.forward(cfg, p, batch["tokens"],
                        img_embeds=batch.get("img_embeds"),
                        enc_embeds=batch.get("enc_embeds"),
                        return_cache=True, last_only=True)
        return _last_logits(cfg, out.logits, batch["tokens"].shape[0]), out.cache

    return step


def _last_logits(cfg, logits: torch.Tensor, n: int) -> torch.Tensor:
    """(B, V) f32 last-position logits; under a mesh gathered over the
    vocab and the batch, the same on every rank (this rank's cache keeps
    its own rows)."""
    last = logits[:, -1]
    mesh = A.get_mesh()
    if mesh is not None:
        if T._vocab_parallel(mesh, cfg.vocab):
            last = A.gather(last, -1, mesh, "model")
        last = A.global_rows(mesh, last, n)
    return _final_logits(cfg, last)


def make_serve_step(cfg: ModelCfg) -> Callable:
    """(params, batch{tokens, cache, write_pos}) -> (logits, cache).

    Optional batch keys ``kv_factors``/``comp_len`` carry the serving
    engine's compressed-prefix state; they ride through read-only.  The
    cache is updated in place and returned."""

    def step(params, batch):
        p = T.cast_params_for_compute(cfg, params)
        out = T.forward(cfg, p, batch["tokens"], cache=batch["cache"],
                        write_pos=batch["write_pos"],
                        kv_factors=batch.get("kv_factors"),
                        comp_len=batch.get("comp_len"), last_only=True)
        return _last_logits(cfg, out.logits, batch["tokens"].shape[0]), out.cache

    return step


def step_for(cfg: ModelCfg, shape: ShapeCfg, **kw) -> Callable:
    """The cell's step: train (``kw`` go to ``make_train_step``), prefill
    or decode."""
    if shape.kind == "train":
        return make_train_step(cfg, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)


__all__ = ["ARCHS", "get_arch", "shapes_for", "smoke_config", "input_specs",
           "materialize_inputs", "make_train_step", "make_prefill_step",
           "make_serve_step", "step_for"]
