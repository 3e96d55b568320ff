"""Pattern-stacked transformer: schema, init, forward (port of
``repro/models/transformer.py``, its attention layers with the dense MLP
or the routed experts).

Params are a flat dict ``{"path/like/this": tensor}`` with the reference's
names and layouts, so ``convert.params_from_reference`` is a dtype
conversion and the tests compare like with like:

  * ``layers/p{i}/...`` — pattern position i of the repeated group; leaves
    have a leading ``n_scan_periods`` dim.  A Python loop over the periods
    takes the place of ``lax.scan`` and indexes each leaf (a view).
  * ``rem{j}/...`` — the n_layers % period remainder layers.
  * ``embed/tokens``, ``final_norm/...``, ``unembed`` (absent when tied).

Caches mirror this: {"pre": (...), "scan": (c_p0, ...), "rem": (...)} with
scan leaves stacked over periods.  Decode writes the new token's k/v into
the cache IN PLACE (write-then-attend) and returns the same cache object;
the reference returns an updated copy.

Served and trained here: ``mixer="attn"`` with ``ffn="mlp"`` or the routed
experts ``ffn="moe"`` (``models/moe.py``), full-context or windowed prefill, full-context decode with or without the factored
prefix, windowed decode and chunked prefill over a ring-buffer cache, and
the single-card training loss (``cross_entropy``, ``loss_fn``;
autograd runs through the forward, which never writes a tensor autograd
saved: the only in-place writes are those of a cache, and training passes
none).
The reference's ``sharding.activation.constrain`` and the mesh branches of
``embed_tokens`` are no-ops on one card and are dropped.  What is not
ported raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod

_NOT_PORTED = {
    "mla": "MLA (ROADMAP Queue 1 item 16c)",
    "rglru": "recurrent mixers (ROADMAP Queue 1 item 16e)",
    "mlstm": "recurrent mixers (ROADMAP Queue 1 item 16e)",
    "slstm": "recurrent mixers (ROADMAP Queue 1 item 16e)",
    "cross_attn": "enc-dec cross-attention (ROADMAP Queue 1 item 16f)",
    "encdec": "the enc-dec encoder (ROADMAP Queue 1 item 16f)",
    "vlm": "the VLM frontend (ROADMAP Queue 1 item 16f)",
    "vocab_parallel": "the vocab-parallel loss across processes (ROADMAP "
                      "Queue 1 item 16g)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{_NOT_PORTED[what]} is not ported yet")


# ---------------------------------------------------------------------------
# Parameter schema: shapes + init scales
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamDef:
    shape: tuple[int, ...]
    scale: float = 0.02               # init std (0 -> zeros)


def _norm_defs(cfg, prefix) -> dict[str, ParamDef]:
    d = {f"{prefix}/scale": ParamDef((cfg.d_model,), 0.0)}
    if cfg.norm == "layernorm":
        d[f"{prefix}/bias"] = ParamDef((cfg.d_model,), 0.0)
    return d


def _layer_defs(cfg: ModelCfg, spec: LayerSpec) -> dict[str, ParamDef]:
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2 * cfg.n_layers)
    if spec.mixer != "attn":
        raise not_ported(spec.mixer)
    if spec.cross_attn:
        raise not_ported("cross_attn")
    defs: dict[str, ParamDef] = {}
    defs.update(_norm_defs(cfg, "norm1"))
    if not cfg.parallel_block and spec.ffn != "none":
        defs.update(_norm_defs(cfg, "norm2"))
    if cfg.post_norms:
        defs.update(_norm_defs(cfg, "norm1_post"))
        defs.update(_norm_defs(cfg, "norm2_post"))
    defs["attn/wq"] = ParamDef((D, H, hd), s_in)
    defs["attn/wk"] = ParamDef((D, KV, hd), s_in)
    defs["attn/wv"] = ParamDef((D, KV, hd), s_in)
    defs["attn/wo"] = ParamDef((H * hd, D), s_out)
    if cfg.qkv_bias:
        defs["attn/bq"] = ParamDef((H, hd), 0.0)
        defs["attn/bk"] = ParamDef((KV, hd), 0.0)
        defs["attn/bv"] = ParamDef((KV, hd), 0.0)
    if cfg.qk_norm:
        defs["attn/q_norm"] = ParamDef((hd,), 0.0)
        defs["attn/k_norm"] = ParamDef((hd,), 0.0)
    if spec.ffn == "mlp":
        defs["mlp/w_gate"] = ParamDef((D, F), s_in)
        defs["mlp/w_up"] = ParamDef((D, F), s_in)
        defs["mlp/w_down"] = ParamDef((F, D), s_out)
    elif spec.ffn == "moe":
        mc = cfg.moe
        E = mc.num_experts
        defs["moe/router"] = ParamDef((D, E), s_in)
        defs["moe/w_gate"] = ParamDef((E, D, mc.d_expert), s_in)
        defs["moe/w_up"] = ParamDef((E, D, mc.d_expert), s_in)
        defs["moe/w_down"] = ParamDef((E, mc.d_expert, D), s_out)
        if mc.num_shared:
            Fs = mc.d_shared or mc.d_expert * mc.num_shared
            defs["moe/shared/w_gate"] = ParamDef((D, Fs), s_in)
            defs["moe/shared/w_up"] = ParamDef((D, Fs), s_in)
            defs["moe/shared/w_down"] = ParamDef((Fs, D), s_out)
    return defs


def schema(cfg: ModelCfg) -> dict[str, ParamDef]:
    """Full parameter schema: path -> ParamDef (the reference's names,
    shapes and init scales)."""
    if cfg.vlm:
        raise not_ported("vlm")
    if cfg.encdec:
        raise not_ported("encdec")
    defs: dict[str, ParamDef] = {}
    defs["embed/tokens"] = ParamDef((cfg.vocab, cfg.d_model), 1.0)
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab), 0.02)
    defs.update(_norm_defs(cfg, "final_norm"))
    for j, spec in enumerate(cfg.prelude):
        for k, d in _layer_defs(cfg, spec).items():
            defs[f"pre{j}/{k}"] = d
    if cfg.n_scan_periods:
        for i, spec in enumerate(cfg.pattern):
            for k, d in _layer_defs(cfg, spec).items():
                defs[f"layers/p{i}/{k}"] = ParamDef(
                    (cfg.n_scan_periods,) + d.shape, d.scale)
    for j in range(cfg.n_remainder):
        for k, d in _layer_defs(cfg, cfg.pattern[j % cfg.period]).items():
            defs[f"rem{j}/{k}"] = d
    return defs


def keeps_f32(name: str, ndim: int) -> bool:
    """Leaves the compute cast leaves f32: those under 2-D (the unstacked
    norm scales) and the MoE router, with which the reference's
    ``moe_block`` routes in f32."""
    return ndim < 2 or name.endswith("moe/router")


def init_params(cfg: ModelCfg, gen: torch.Generator, *,
                compute_dtype: bool = False) -> dict[str, torch.Tensor]:
    """Random weights at the schema's scales, drawn from ``gen`` on its
    device (names in sorted order, one normal draw each).  The reference
    draws from ``jax.random``; tests load its weights through
    ``convert.params_from_reference`` instead.

    ``compute_dtype`` draws every random leaf that
    ``cast_params_for_compute`` would cast straight into the activation
    dtype, one leading-period slice of a stacked leaf at a time (an f32
    draw of one slice, scaled and cast), so no f32 copy of a whole leaf or
    of the model exists: the f32 masters of qwen3-moe-30b-a3b are 122 GB,
    and one stacked expert leaf a 38.6 GB f32 draw.  The router and the
    zero-initialised leaves (norm scales, biases) stay f32.  These are
    other numbers than the f32 masters' draw from the same generator."""
    dtype = getattr(torch, cfg.param_dtype)
    act = _act_dtype(cfg)
    dev = gen.device
    params = {}
    for name, d in sorted(schema(cfg).items()):
        if d.scale == 0.0:
            params[name] = torch.zeros(d.shape, dtype=dtype, device=dev)
        elif (compute_dtype and dtype == torch.float32
              and not keeps_f32(name, len(d.shape))):
            w = torch.empty(d.shape, dtype=act, device=dev)
            for part in (w if name.startswith("layers/") else w[None]):
                part.copy_(torch.randn(part.shape, generator=gen,
                                       dtype=torch.float32,
                                       device=dev).mul_(d.scale))
            params[name] = w
        else:
            w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=dev)
            params[name] = (w.mul_(d.scale)).to(dtype)
    return params


def param_count(cfg: ModelCfg) -> int:
    return sum(math.prod(d.shape) for d in schema(cfg).values())


def active_param_count(cfg: ModelCfg) -> int:
    """Active params per token (MoE: top_k of num_experts experts)."""
    total = 0
    for name, d in schema(cfg).items():
        n = math.prod(d.shape)
        if cfg.moe and "/moe/w_" in name and "shared" not in name:
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


def cast_params_for_compute(cfg: ModelCfg, params: dict) -> dict:
    """Cast the f32 masters to the activation dtype, all but the
    ``keeps_f32`` leaves (norm scales, the MoE router).  The reference casts
    inside every step; the port's serving entry points cast once at load
    (the numbers are the same), after which this returns the tensors it is
    given.  (The reference's cast rounds the router to bf16 too, so its
    registry steps route on a bf16 router; its ``moe_block`` routes in f32
    and the port keeps the router f32 everywhere.)  The cast is differentiable: the train
    step's gradients reach the f32 masters through it, the bf16 cotangent
    cast to f32 as in the reference."""
    dt = getattr(torch, cfg.activation_dtype)
    return {k: (w.to(dt) if w.dtype == torch.float32
                and not keeps_f32(k, w.ndim) else w)
            for k, w in params.items()}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def sub(d: dict[str, Any], prefix: str) -> dict[str, Any]:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _act_dtype(cfg):
    return getattr(torch, cfg.activation_dtype)


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------

def apply_layer(cfg: ModelCfg, spec: LayerSpec, p: dict, x: torch.Tensor, *,
                positions, rope, cache, write_pos, return_cache: bool,
                causal: bool = True, factors=None, comp_len=None):
    """Residual block: norm -> attention -> (+) [norm -> mlp/moe -> (+)].
    ``rope`` is the (cos, sin) of ``positions`` (None without RoPE).
    Returns (x, new_cache_dict_or_None)."""
    if spec.mixer != "attn":
        raise not_ported(spec.mixer)
    if spec.cross_attn:
        raise not_ported("cross_attn")
    h = L.apply_norm(cfg, p, "norm1", x)
    c = None
    if cache is not None and "k" in cache:
        c = L.KVCache(cache["k"], cache["v"])
    mix, kv = _attn_with_cache(cfg, spec, p, h, positions=positions,
                               rope=rope, cache=c,
                               write_pos=write_pos, return_cache=return_cache,
                               causal=causal, factors=factors,
                               comp_len=comp_len)
    new_cache = {"k": kv.k, "v": kv.v} if kv is not None else None
    if cfg.post_norms:
        mix = L.apply_norm(cfg, p, "norm1_post", mix)
    if cfg.parallel_block and spec.ffn != "none":
        return x + (_ffn(cfg, spec, p, h) + mix), new_cache
    x = x + mix
    if spec.ffn != "none":
        ff = _ffn(cfg, spec, p, L.apply_norm(cfg, p, "norm2", x))
        if cfg.post_norms:
            ff = L.apply_norm(cfg, p, "norm2_post", ff)
        x = x + ff
    return x, new_cache


def _ffn(cfg, spec, p, h):
    """The layer's feed-forward block: the gated MLP or the routed experts."""
    if spec.ffn == "moe":
        return moe_mod.moe_block(cfg, p, h)
    return L.mlp_block(cfg, p, h)


def _attn_with_cache(cfg, spec, p, h, *, positions, rope, cache, write_pos,
                     return_cache, causal, factors=None, comp_len=None):
    """Attention block: prefill (no cache; returns the cache it builds) or
    write-then-attend with a cache, whose factored branch attends through a
    compressed prefix."""
    dt = h.dtype
    scale = cfg.query_scale or (1.0 / math.sqrt(cfg.head_dim))
    q, k, v = L.qkv_project(cfg, p, "attn", h)
    if rope is not None:
        cos, sin = rope
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)

    if cache is None:
        use_flash = (cfg.use_flash_kernel and causal and spec.window is None
                     and cfg.attn_softcap == 0.0)
        if use_flash:
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(q, k, v, causal=True, scale=scale)
        else:
            out = L.attention(q, k, v, causal=causal, window=spec.window,
                              scale=scale, cap=cfg.attn_softcap,
                              q_positions=positions, kv_positions=positions,
                              chunk=cfg.attn_chunk)
        kv = None
        if return_cache:
            if spec.window is not None and spec.window < k.shape[1]:
                kv = L.KVCache(k[:, -spec.window:], v[:, -spec.window:])
            else:
                kv = L.KVCache(k, v)
    elif spec.window is not None and cache.k.shape[1] <= spec.window:
        out = _ring_attend(cfg, q, k, v, cache, positions, int(write_pos),
                           scale=scale, causal=causal)
        kv = cache
    else:
        s_kv = cache.k.shape[1]
        sq = q.shape[1]
        wp = int(write_pos)
        if not 0 <= wp <= s_kv - sq:
            raise ValueError(f"write_pos={wp} + {sq} rows overruns the cache "
                             f"of {s_kv}")
        cache.k[:, wp:wp + sq] = k.to(cache.k.dtype)
        cache.v[:, wp:wp + sq] = v.to(cache.v.dtype)
        kv = cache
        if factors and comp_len is not None and sq == 1:
            # rows [0, comp_len_b) live only as rank-r factors; only
            # full-context layers carry factors, so no window binds here
            if cfg.use_flash_kernel:
                from repro_torch.kernels import ops as kops
                out = kops.factored_decode_attention(
                    q, kv.k, kv.v, factors["k_us"], factors["k_vt"],
                    factors["v_us"], factors["v_vt"], comp_len, wp,
                    scale=scale, cap=cfg.attn_softcap)
            else:
                out = L.factored_decode_attention(
                    q, kv.k, kv.v, factors["k_us"], factors["k_vt"],
                    factors["v_us"], factors["v_vt"], comp_len,
                    write_pos=wp, scale=scale, cap=cfg.attn_softcap)
        else:
            out = L.attention(q, kv.k.to(dt), kv.v.to(dt), causal=causal,
                              window=spec.window, scale=scale,
                              cap=cfg.attn_softcap,
                              q_positions=positions,
                              kv_positions=torch.arange(s_kv, device=h.device),
                              chunk=cfg.attn_chunk)
    b, sq = out.shape[:2]
    out = out.reshape(b, sq, -1) @ p["attn/wo"].to(dt)
    return out, kv


def _ring_attend(cfg, q, k, v, cache, positions, write_pos: int, *, scale,
                 causal):
    """Attention of a windowed layer over its ring-buffer cache of s_kv <=
    window rows: ring slot i holds absolute position ``write_pos - ((wp - i)
    mod s_kv)``, ``wp = write_pos mod s_kv`` (the reference's formula), so
    every token attends exactly the s_kv positions ending at its own —
    slots not written yet hold zeros at negative positions, as in the
    reference.

    One token (decode) writes its row at slot ``wp`` and attends the ring,
    as the reference does.  A chunk of sq > 1 tokens at ``write_pos``
    onwards cannot write first: its rows would overwrite ring slots that
    its own earlier tokens still attend (token i needs the old rows of
    positions after ``write_pos + i - s_kv``).  So it attends over the old
    ring, rotated into position order, followed by the chunk's own rows
    (rounded to the cache dtype as the reference's writes are), each token
    masked to its trailing s_kv positions, and writes the ring afterwards:
    the reference's token-by-token prefill, computed at once."""
    dt = q.dtype
    s_kv, sq = cache.k.shape[1], q.shape[1]
    if write_pos < 0:
        raise ValueError(f"write_pos={write_pos} must be >= 0")
    dev = q.device
    if sq == 1:
        wp = write_pos % s_kv
        cache.k[:, wp] = k[:, 0].to(cache.k.dtype)
        cache.v[:, wp] = v[:, 0].to(cache.v.dtype)
        kv_pos = write_pos - torch.remainder(
            wp - torch.arange(s_kv, device=dev), s_kv)
        return L.attention(q, cache.k.to(dt), cache.v.to(dt), causal=causal,
                           window=s_kv, scale=scale, cap=cfg.attn_softcap,
                           q_positions=positions, kv_positions=kv_pos,
                           chunk=cfg.attn_chunk)
    old = torch.remainder(write_pos - s_kv + torch.arange(s_kv, device=dev),
                          s_kv)
    k_new, v_new = k.to(cache.k.dtype), v.to(cache.v.dtype)
    k_all = torch.cat([cache.k[:, old], k_new], dim=1).to(dt)
    v_all = torch.cat([cache.v[:, old], v_new], dim=1).to(dt)
    kv_pos = torch.arange(write_pos - s_kv, write_pos + sq, device=dev)
    out = L.attention(q, k_all, v_all, causal=causal, window=s_kv,
                      scale=scale, cap=cfg.attn_softcap,
                      q_positions=positions, kv_positions=kv_pos,
                      chunk=cfg.attn_chunk)
    n = min(sq, s_kv)                   # rows older than a lap never land
    slots = torch.remainder(
        torch.arange(write_pos + sq - n, write_pos + sq, device=dev), s_kv)
    cache.k[:, slots] = k_new[:, sq - n:]
    cache.v[:, slots] = v_new[:, sq - n:]
    return out


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def apply_stack(cfg: ModelCfg, params: dict, x: torch.Tensor, *, positions,
                rope, cache, write_pos, return_cache: bool, causal: bool = True,
                kv_factors=None, comp_len=None):
    """Prelude layers, the repeated pattern group (a loop over periods on
    views of the stacked leaves) and the remainder layers."""
    has_cache = cache is not None
    has_f = kv_factors is not None
    collect = return_cache and not has_cache

    def run(x, spec, p, c, f):
        return apply_layer(cfg, spec, p, x, positions=positions, rope=rope,
                           cache=c,
                           write_pos=write_pos, return_cache=return_cache,
                           causal=causal, factors=f, comp_len=comp_len)

    new_pre = []
    for j, spec in enumerate(cfg.prelude):
        x, nc = run(x, spec, sub(params, f"pre{j}/"),
                    cache["pre"][j] if has_cache else None,
                    kv_factors["pre"][j] if has_f else None)
        new_pre.append(nc or {})

    n_periods = cfg.n_scan_periods
    subs = [sub(params, f"layers/p{i}/") for i in range(cfg.period)]
    stacked: list[dict] = [{} for _ in cfg.pattern]
    for t in range(n_periods):
        for i, spec in enumerate(cfg.pattern):
            p_ti = {k: w[t] for k, w in subs[i].items()}
            c_ti = ({k: w[t] for k, w in cache["scan"][i].items()}
                    if has_cache else None)
            f_ti = ({k: w[t] for k, w in kv_factors["scan"][i].items()}
                    if has_f else None)
            x, nc = run(x, spec, p_ti, c_ti, f_ti)
            if collect and nc:
                # prefill: write each layer's k/v into one stacked leaf
                for name, leaf in nc.items():
                    if name not in stacked[i]:
                        stacked[i][name] = leaf.new_empty(
                            (n_periods,) + tuple(leaf.shape))
                    stacked[i][name][t] = leaf

    new_rem = []
    for j in range(cfg.n_remainder):
        x, nc = run(x, cfg.pattern[j % cfg.period], sub(params, f"rem{j}/"),
                    cache["rem"][j] if has_cache else None,
                    kv_factors["rem"][j] if has_f else None)
        new_rem.append(nc or {})

    if has_cache:
        return x, cache                    # updated in place
    if return_cache:
        return x, {"pre": tuple(new_pre),
                   "scan": tuple(stacked) if n_periods else None,
                   "rem": tuple(new_rem)}
    return x, None


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    cache: Optional[dict]


def embed_tokens(cfg, params, tokens):
    x = params["embed/tokens"][tokens].to(_act_dtype(cfg))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def forward(cfg: ModelCfg, params: dict, tokens: torch.Tensor, *,
            cache: Optional[dict] = None, write_pos: int = 0,
            return_cache: bool = False, kv_factors: Optional[dict] = None,
            comp_len: Optional[torch.Tensor] = None,
            last_only: bool = False) -> ForwardOut:
    """tokens: (B, S).  Decode: S == 1 with a populated cache.

    ``kv_factors``/``comp_len`` (serving only): the per-layer rank-r KV
    factors of ``cache.build_kv_factors`` plus the per-slot compressed
    prefix length.  ``last_only`` computes the logits of the last position
    alone, (B, 1, V): at S = 32768 the full (B, S, V) logits would be 10 GB.
    Logits stay in the activation dtype, as in the reference."""
    if cfg.vlm is not None:
        raise not_ported("vlm")
    if cfg.encdec is not None:
        raise not_ported("encdec")
    x = embed_tokens(cfg, params, tokens)
    dev = x.device
    # With a cache the tokens sit at write_pos onwards (the reference's
    # single-token decode position; it numbers a multi-token chunk from 0,
    # which only its token-by-token prefill never meets).  RoPE tables are
    # computed once here, not in every layer.
    start = int(write_pos) if cache is not None else 0
    positions = torch.arange(start, start + x.shape[1], device=dev)
    rope = (L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.use_rope else None)
    x, new_cache = apply_stack(cfg, params, x, positions=positions, rope=rope,
                               cache=cache, write_pos=write_pos,
                               return_cache=return_cache,
                               kv_factors=kv_factors, comp_len=comp_len)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(cfg, params, "final_norm", x)
    dt = x.dtype
    if cfg.tie_embeddings:
        logits = x @ params["embed/tokens"].to(dt).T
    else:
        logits = x @ params["unembed"].to(dt)
    return ForwardOut(logits, new_cache)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  final_softcap: float = 0.0, *, mesh=None) -> torch.Tensor:
    """Masked mean cross-entropy; labels < 0 are ignored (padding).  Logits
    arrive in the activation dtype and are upcast (and softcapped) here, so
    the cotangent leaving is in that dtype, as in the reference.

    This is the reference's single-card branch.  Its vocab-parallel branch
    (the vocab sharded over a mesh's ``model`` axis) is not ported: a
    ``mesh`` (``launch.mesh.HostMesh``) with a model axis above 1 raises."""
    if mesh is not None and "model" in mesh.shape and mesh.size("model") > 1:
        raise not_ported("vocab_parallel")
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lg = L.softcap(logits.float(), final_softcap)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


def loss_fn(cfg: ModelCfg, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"},
    (B, S) integer tensors) under ``params`` (cast for compute by the
    caller).  VLM and enc-dec configurations raise, as ``forward`` does."""
    out = forward(cfg, params, batch["tokens"])
    return cross_entropy(out.logits, batch["labels"], cfg.final_softcap)
