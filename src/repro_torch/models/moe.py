"""Top-k routed Mixture-of-Experts with sort-based capacity dispatch (port of
``repro/models/moe.py``, its single-card branch).

Token-choice pairs are sorted by expert id (a stable sort, so within an
expert they keep token order), positioned within their expert by a running
count, dropped past the static capacity, and moved through an (E, C, D)
buffer:

  tokens (N, D) --gather--> (E, C, D) --batched FFN--> (E, C, D) --combine--> (N, D)

Which pairs drop is part of the result, so the sort, the positions and the
drops follow the reference step for step.  The router runs in f32 (its
leaves stay f32 through ``transformer.cast_params_for_compute``).  The
combine adds each token's k contributions in ascending expert-id order in
the activation dtype, as the reference's scatter-add over the sorted pairs
does, as a gather and k - 1 adds: an atomic ``index_add_`` on the card
adds in no fixed order, and bf16 sums would differ from run to run.

Under an active mesh with a ``model`` axis that divides the experts, the
reference's expert-parallel branch: every rank routes its own tokens (its
rows of the batch), runs the experts [e_start, e_start + e_local) of its
``model`` shard on them and the combine is all-reduced over ``model``.
The capacity counts the global batch over the batch ranks, as the
reference's.  With no mesh, or a ``model`` axis of 1, the single-card
branch runs as before.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import activation
from repro_torch.sharding import activation as A


def capacity(n_tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(n_tokens * top_k * capacity_factor / num_experts)
    return max(8, min(c, n_tokens))


def dropless(cfg):
    """``cfg`` with a capacity factor of ``num_experts``: every expert's
    capacity is then max(8, n) >= n, the most pairs one expert can get (a
    token picks k distinct experts), so no pair drops.  The serving model
    step prefills a chunk of one slot under it where the reference's token-
    by-token prefill over the pool drops nothing either."""
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def route(cfg, logits: torch.Tensor):
    """Top-k of the f32 softmax of the router logits (N, E): (gates,
    experts), each (N, k), gates renormalised when ``norm_topk``."""
    gates, experts = torch.topk(torch.softmax(logits, dim=-1), cfg.moe.top_k,
                                dim=-1)
    if cfg.moe.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts


def _dispatch_ffn_combine(cfg, tokens, logits, wg, wu, wd, *, cap: int,
                          e_start: int = 0, e_local=None):
    """Sort-based dispatch of ``tokens`` (N, D) to experts [e_start,
    e_start + e_local) (all E by default), batched FFN, gate-weighted
    combine -> (N, D) in the tokens' dtype; the other experts' pairs add
    nothing (the expert-parallel caller sums over the ranks)."""
    dt = tokens.dtype
    n, d = tokens.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    e = e if e_local is None else e_local
    dev = tokens.device
    gates, experts = route(cfg, logits)

    flat_expert = experts.reshape(-1)                    # (N*k,) token-major
    flat_token = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sgate = flat_expert[order], flat_token[order], gates.reshape(-1)[order]
    within = (torch.arange(n * k, device=dev)
              - torch.searchsorted(se, se, side="left"))
    local_e = se - e_start
    keep = (within < cap) & (local_e >= 0) & (local_e < e)
    slot = torch.where(keep, local_e * cap + within, e * cap)

    # slot e*cap is the reference's out-of-bounds index: its writes drop
    src = torch.full((e * cap + 1,), n, dtype=torch.long, device=dev)
    src[slot] = stok
    tok_pad = torch.cat([tokens, tokens.new_zeros((1, d))])
    xe = tok_pad[src[:-1]].reshape(e, cap, d)            # (E, C, D)

    h = activation(cfg.act, torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd).reshape(e * cap, d)
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))])
    contrib = ye_pad[slot] * sgate[:, None].to(dt)       # dropped pairs: 0

    # each token's k contributions in the sorted order (ascending expert
    # id), summed one by one in dt from the first
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=dev)
    per_tok = contrib[inv].reshape(n, k, d)              # the tokens' top-k order
    by_id = torch.argsort(experts, dim=-1)
    per_tok = torch.gather(per_tok, 1, by_id[..., None].expand(n, k, d))
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out


def moe_block(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts over the B*S tokens
    (capacity from their count), plus the shared experts where the config
    has them.  Under a mesh: the expert-parallel branch (module
    docstring), ``p``'s routed expert leaves this rank's E/model."""
    mcfg = cfg.moe
    dt = x.dtype
    b, s, d = x.shape
    n = b * s
    tokens = x.reshape(n, d)
    mesh = A.get_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        b_global = A.get_global_batch() or b
        out = _expert_parallel(cfg, p, tokens, mesh, b_global=b_global,
                               s=s).reshape(b, s, d)
    else:
        logits = tokens.float() @ p["moe/router"].float()
        cap = capacity(n, mcfg.num_experts, mcfg.top_k, mcfg.capacity_factor)
        out = _dispatch_ffn_combine(
            cfg, tokens, logits, p["moe/w_gate"].to(dt), p["moe/w_up"].to(dt),
            p["moe/w_down"].to(dt), cap=cap).reshape(b, s, d)

    if mcfg.num_shared:                      # dense MLP, always on (deepseek)
        gate = tokens @ p["moe/shared/w_gate"].to(dt)
        up = tokens @ p["moe/shared/w_up"].to(dt)
        shared = (activation(cfg.act, gate) * up) @ p["moe/shared/w_down"].to(dt)
        out = out + shared.reshape(b, s, d)
    return out


def _expert_parallel(cfg, p, tokens, mesh, *, b_global: int, s: int):
    """This rank's experts on its tokens (N_local, D), summed over
    ``model``.  The tokens and the router enter the split work alike on
    every model rank, so their cotangents sum over ``model``; the sum of
    the ranks' parts is the same everywhere, so its cotangent passes."""
    mcfg = cfg.moe
    e, k = mcfg.num_experts, mcfg.top_k
    n_model = mesh.size("model")
    if e % n_model:
        raise ValueError(f"{e} experts do not split over a model axis of "
                         f"{n_model}")
    e_local = e // n_model
    dp = mesh.world_size // n_model
    n_loc = max(1, b_global * s // dp)
    cap = capacity(n_loc, e, k, mcfg.capacity_factor)
    dt = tokens.dtype
    toks = A.enter(tokens, "model", mesh)
    logits = toks.float() @ A.enter(p["moe/router"], "model", mesh).float()
    out = _dispatch_ffn_combine(
        cfg, toks, logits, p["moe/w_gate"].to(dt), p["moe/w_up"].to(dt),
        p["moe/w_down"].to(dt), cap=cap,
        e_start=mesh.index("model") * e_local, e_local=e_local)
    return A.psum(out, "model", mesh)


def aux_load_balance_loss(logits_f32: torch.Tensor, experts: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (for the train loop)."""
    probs = torch.softmax(logits_f32, dim=-1)
    me = probs.mean(0)
    one_hot = torch.nn.functional.one_hot(experts[..., 0].long(),
                                          num_experts).to(probs.dtype)
    ce = one_hot.mean(0)
    return num_experts * torch.sum(me * ce)
