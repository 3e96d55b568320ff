"""Pattern-stacked transformer: schema, init, forward (port of
``repro/models/transformer.py``: attention, MLA and recurrent layers with
the dense MLP, the routed experts or no feed-forward block).

Params are a flat dict ``{"path/like/this": tensor}`` with the reference's
names and layouts, so ``convert.params_from_reference`` is a dtype
conversion and the tests compare like with like:

  * ``layers/p{i}/...`` — pattern position i of the repeated group; leaves
    have a leading ``n_scan_periods`` dim.  A Python loop over the periods
    takes the place of ``lax.scan`` and indexes each leaf (a view).
  * ``rem{j}/...`` — the n_layers % period remainder layers.
  * ``enc/layers/p0/...``, ``enc/final_norm/...`` — whisper's encoder
    stack (leading ``enc_layers`` dim); ``vlm/proj`` — the VLM's image
    projection.
  * ``embed/tokens``, ``final_norm/...``, ``unembed`` (absent when tied).

Caches mirror this: {"pre": (...), "scan": (c_p0, ...), "rem": (...)} with
scan leaves stacked over periods.  Decode writes the new token's k/v into
the cache IN PLACE (write-then-attend) and returns the same cache object;
the reference returns an updated copy.

Served and trained here: ``mixer="attn"``, ``mixer="mla"`` (DeepSeek's
latent attention, ``models/mla.py``) and the recurrent mixers ``rglru``,
``mlstm`` and ``slstm`` (``models/recurrent.py``) with ``ffn="mlp"``, the
routed experts ``ffn="moe"`` (``models/moe.py``) or none, whisper's
encoder and decoder cross-attention (``encoder_forward``, the cache's
``xk``/``xv``), the VLM's projected image rows put before the text,
full-context or windowed prefill (a windowed layer's cache left in ring
order), full-context decode with or without the factored
prefix, windowed decode and chunked prefill over a ring-buffer cache,
absorbed latent decode and chunked prefill into a latent cache, recurrent
state carried through a cache (written back in place), and
the training loss (``cross_entropy``, ``loss_fn``;
autograd runs through the forward, which never writes a tensor autograd
saved: the only in-place writes are those of a cache, and training passes
none).

Under an active mesh (``sharding.activation.set_mesh``; one process a
device) the entry points take the global batch and params stored as the
registered specs (``sharding.rules``): ``forward`` keeps this rank's rows
(``activation.local_rows``), ``cast_params_for_compute`` gathers every
stored leaf but the vocab tables' and the routed experts' ``model`` slices
(the reference's ZeRO path), the embedding and the logits are
vocab-parallel and the routed experts expert-parallel (``models/moe.py``).
The model axis computes the rest alike on each of its ranks: where the
reference splits heads and MLP across it (tensor parallelism, its
``tp`` flag) the port gathers them too, which changes where work runs,
not what it computes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.sharding import activation as A

# whisper's encoder layers: dense attention and MLP, no cross-attention
ENC_SPEC = LayerSpec(mixer="attn", ffn="mlp")


# ---------------------------------------------------------------------------
# Parameter schema: shapes + init scales
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axes (sharding/rules.py)
    scale: float = 0.02               # init std (0 -> zeros)


def _norm_defs(cfg, prefix) -> dict[str, ParamDef]:
    d = {f"{prefix}/scale": ParamDef((cfg.d_model,), (None,), 0.0)}
    if cfg.norm == "layernorm":
        d[f"{prefix}/bias"] = ParamDef((cfg.d_model,), (None,), 0.0)
    return d


def _layer_defs(cfg: ModelCfg, spec: LayerSpec) -> dict[str, ParamDef]:
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs: dict[str, ParamDef] = {}
    defs.update(_norm_defs(cfg, "norm1"))
    if not cfg.parallel_block and spec.ffn != "none":
        defs.update(_norm_defs(cfg, "norm2"))
    if cfg.post_norms:
        defs.update(_norm_defs(cfg, "norm1_post"))
        defs.update(_norm_defs(cfg, "norm2_post"))
    if spec.mixer == "mla":
        m = cfg.mla
        defs["mla/wq"] = ParamDef((D, H, m.qk_nope_dim + m.qk_rope_dim),
                                   ("embed", "heads", None), s_in)
        defs["mla/w_dkv"] = ParamDef((D, m.kv_lora_rank), ("embed", None), s_in)
        defs["mla/kv_norm"] = ParamDef((m.kv_lora_rank,), (None,), 0.0)
        defs["mla/w_kr"] = ParamDef((D, m.qk_rope_dim), ("embed", None), s_in)
        defs["mla/w_uk"] = ParamDef((m.kv_lora_rank, H, m.qk_nope_dim),
                                    (None, "heads", None), s_in)
        defs["mla/w_uv"] = ParamDef((m.kv_lora_rank, H, m.v_head_dim),
                                    (None, "heads", None), s_in)
        defs["mla/wo"] = ParamDef((H * m.v_head_dim, D), ("heads", "embed"),
                                  s_out)
    elif spec.mixer == "rglru":
        Dr = cfg.rnn.d_rnn or D
        W = cfg.rnn.conv_width
        defs["rnn/w_in"] = ParamDef((D, Dr), ("embed", "inner"), s_in)
        defs["rnn/w_gate_in"] = ParamDef((D, Dr), ("embed", "inner"), s_in)
        defs["rnn/conv_w"] = ParamDef((W, Dr), (None, "inner"), 0.3)
        defs["rnn/w_a"] = ParamDef((Dr, Dr), ("inner", "inner2"), s_in)
        defs["rnn/w_x"] = ParamDef((Dr, Dr), ("inner", "inner2"), s_in)
        defs["rnn/lam"] = ParamDef((Dr,), ("inner",), 0.5)
        defs["rnn/w_out"] = ParamDef((Dr, D), ("inner", "embed"), s_out)
    elif spec.mixer == "mlstm":
        Di = int(cfg.rnn.mlstm_proj_factor * D)
        W = cfg.rnn.conv_width
        defs["mlstm/w_up"] = ParamDef((D, Di), ("embed", "inner"), s_in)
        defs["mlstm/w_z"] = ParamDef((D, Di), ("embed", "inner"), s_in)
        defs["mlstm/conv_w"] = ParamDef((W, Di), (None, "inner"), 0.3)
        defs["mlstm/wq"] = ParamDef((Di, Di), ("inner", "inner2"), s_in)
        defs["mlstm/wk"] = ParamDef((Di, Di), ("inner", "inner2"), s_in)
        defs["mlstm/wv"] = ParamDef((Di, Di), ("inner", "inner2"), s_in)
        defs["mlstm/w_ig"] = ParamDef((Di, H), ("inner", None), s_in)
        defs["mlstm/w_fg"] = ParamDef((Di, H), ("inner", None), s_in)
        defs["mlstm/w_down"] = ParamDef((Di, D), ("inner", "embed"), s_out)
    elif spec.mixer == "slstm":
        hd_s = D // H
        defs["slstm/w_x"] = ParamDef((D, 4 * D), ("embed", "inner"), s_in)
        defs["slstm/r"] = ParamDef((H, hd_s, 4 * hd_s),
                                   ("heads", None, None), s_in)
        defs["slstm/w_out"] = ParamDef((D, D), ("inner", "embed"), s_out)
    elif spec.mixer == "attn":
        defs["attn/wq"] = ParamDef((D, H, hd), ("embed", "heads", None), s_in)
        defs["attn/wk"] = ParamDef((D, KV, hd), ("embed", "heads", None), s_in)
        defs["attn/wv"] = ParamDef((D, KV, hd), ("embed", "heads", None), s_in)
        defs["attn/wo"] = ParamDef((H * hd, D), ("heads", "embed"), s_out)
        if cfg.qkv_bias:
            defs["attn/bq"] = ParamDef((H, hd), ("heads", None), 0.0)
            defs["attn/bk"] = ParamDef((KV, hd), ("heads", None), 0.0)
            defs["attn/bv"] = ParamDef((KV, hd), ("heads", None), 0.0)
        if cfg.qk_norm:
            defs["attn/q_norm"] = ParamDef((hd,), (None,), 0.0)
            defs["attn/k_norm"] = ParamDef((hd,), (None,), 0.0)
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        defs["xattn/wq"] = ParamDef((D, H, hd), ("embed", "heads", None), s_in)
        defs["xattn/wk"] = ParamDef((D, KV, hd), ("embed", "heads", None), s_in)
        defs["xattn/wv"] = ParamDef((D, KV, hd), ("embed", "heads", None), s_in)
        defs["xattn/wo"] = ParamDef((H * hd, D), ("heads", "embed"), s_out)
        defs.update(_norm_defs(cfg, "norm_x"))
    if spec.ffn == "mlp":
        defs["mlp/w_gate"] = ParamDef((D, F), ("embed", "mlp"), s_in)
        defs["mlp/w_up"] = ParamDef((D, F), ("embed", "mlp"), s_in)
        defs["mlp/w_down"] = ParamDef((F, D), ("mlp", "embed"), s_out)
    elif spec.ffn == "moe":
        mc = cfg.moe
        E = mc.num_experts
        defs["moe/router"] = ParamDef((D, E), ("embed", None), s_in)
        defs["moe/w_gate"] = ParamDef((E, D, mc.d_expert),
                                      ("expert", "embed", None), s_in)
        defs["moe/w_up"] = ParamDef((E, D, mc.d_expert),
                                    ("expert", "embed", None), s_in)
        defs["moe/w_down"] = ParamDef((E, mc.d_expert, D),
                                      ("expert", None, "embed"), s_out)
        if mc.num_shared:
            Fs = mc.d_shared or mc.d_expert * mc.num_shared
            defs["moe/shared/w_gate"] = ParamDef((D, Fs), ("embed", "mlp"), s_in)
            defs["moe/shared/w_up"] = ParamDef((D, Fs), ("embed", "mlp"), s_in)
            defs["moe/shared/w_down"] = ParamDef((Fs, D), ("mlp", "embed"), s_out)
    return defs


def schema(cfg: ModelCfg) -> dict[str, ParamDef]:
    """Full parameter schema: path -> ParamDef (the reference's names,
    shapes and init scales)."""
    defs: dict[str, ParamDef] = {}
    defs["embed/tokens"] = ParamDef((cfg.vocab, cfg.d_model),
                                    ("vocab", "embed"), 1.0)
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"), 0.02)
    defs.update(_norm_defs(cfg, "final_norm"))
    if cfg.vlm:
        defs["vlm/proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                    ("embed", "embed2"), 0.02)
    for j, spec in enumerate(cfg.prelude):
        for k, d in _layer_defs(cfg, spec).items():
            defs[f"pre{j}/{k}"] = d
    if cfg.n_scan_periods:
        for i, spec in enumerate(cfg.pattern):
            for k, d in _layer_defs(cfg, spec).items():
                defs[f"layers/p{i}/{k}"] = ParamDef(
                    (cfg.n_scan_periods,) + d.shape, ("layers",) + d.axes,
                    d.scale)
    for j in range(cfg.n_remainder):
        for k, d in _layer_defs(cfg, cfg.pattern[j % cfg.period]).items():
            defs[f"rem{j}/{k}"] = d
    if cfg.encdec:                   # whisper's encoder: dense layers, stacked
        for k, d in _layer_defs(cfg, ENC_SPEC).items():
            defs[f"enc/layers/p0/{k}"] = ParamDef(
                (cfg.encdec.enc_layers,) + d.shape, ("layers",) + d.axes,
                d.scale)
        defs.update({f"enc/{k}": d
                     for k, d in _norm_defs(cfg, "final_norm").items()})
    return defs


def keeps_f32(name: str, ndim: int) -> bool:
    """Leaves the compute cast leaves f32: those under 2-D (the unstacked
    norm scales) and the MoE router, with which the reference's
    ``moe_block`` routes in f32.  Stacked norm scales (``mla/kv_norm`` of
    the scan layers among them) are 2-D and cast, as the reference casts
    every leaf of two dims or more."""
    return ndim < 2 or name.endswith("moe/router")


def init_params(cfg: ModelCfg, gen: torch.Generator, *,
                compute_dtype: bool = False, mesh=None,
                specs: Optional[dict] = None) -> dict[str, torch.Tensor]:
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
    other numbers than the f32 masters' draw from the same generator.

    With a bound ``mesh`` and ``specs`` (``sharding.rules``) the rank makes
    the same draws and keeps its slice of each (of each period slice), so
    its leaves are bit for bit the slices of the one-process draw and no
    whole leaf of the activation dtype is ever built."""
    dtype = getattr(torch, cfg.param_dtype)
    act = _act_dtype(cfg)
    dev = gen.device

    def cut(x, spec):
        return x if specs is None else A.slice_leaf(x, spec, mesh)

    params = {}
    for name, d in sorted(schema(cfg).items()):
        spec = specs[name] if specs is not None else (None,) * len(d.shape)
        shape = tuple(n // (1 if e is None else mesh.size(e))
                      for n, e in zip(d.shape, spec))
        if d.scale == 0.0:
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif (compute_dtype and dtype == torch.float32
              and not keeps_f32(name, len(d.shape))):
            w = torch.empty(shape, dtype=act, device=dev)
            stacked = name.startswith(("layers/", "enc/layers/"))
            whole = d.shape[1:] if stacked else d.shape
            sub_spec = spec[1:] if stacked else spec
            for part in (w if stacked else w[None]):
                part.copy_(cut(torch.randn(whole, generator=gen,
                                           dtype=torch.float32,
                                           device=dev).mul_(d.scale), sub_spec))
            params[name] = w
        else:
            w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=dev)
            w = (w.mul_(d.scale)).to(dtype)
            params[name] = w if specs is None else cut(w, spec).clone()
    return params


def abstract_params(cfg: ModelCfg) -> dict[str, torch.Tensor]:
    """Every parameter as a meta tensor of the schema's shape in
    ``cfg.param_dtype``: the reference's ``ShapeDtypeStruct`` stand-ins,
    nothing allocated."""
    dtype = getattr(torch, cfg.param_dtype)
    return {name: torch.empty(d.shape, dtype=dtype, device="meta")
            for name, d in schema(cfg).items()}


def param_count(cfg: ModelCfg) -> int:
    return sum(math.prod(d.shape) for d in schema(cfg).values())


def active_param_count(cfg: ModelCfg) -> int:
    """Active params per token (MoE: top_k of num_experts experts)."""
    total = 0
    for name, d in schema(cfg).items():
        n = math.prod(d.shape)
        if cfg.moe and _is_expert(name):
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
    cast to f32 as in the reference.

    Under an active mesh each cast leaf is then gathered
    (``activation.gather_leaf`` over its ``compute_spec``), so the bytes on
    the wire are the activation dtype's.  That gather is not
    differentiated: the train step calls this under ``torch.no_grad`` and
    maps the gathered copies' gradients back itself
    (``registry.loss_and_grads``)."""
    dt = getattr(torch, cfg.activation_dtype)
    out = {k: (w.to(dt) if w.dtype == torch.float32
               and not keeps_f32(k, w.ndim) else w)
           for k, w in params.items()}
    mesh = A.get_mesh()
    if mesh is None:
        return out
    specs = stored_specs(cfg, mesh)
    return {k: A.gather_leaf(w, compute_spec(k, specs[k]), mesh)
            for k, w in out.items()}


def stored_specs(cfg: ModelCfg, mesh) -> dict:
    """The specs the params are stored as under ``mesh``: the registered
    ones (``activation.set_param_specs``), else the training layout."""
    specs = A.get_param_specs()
    if specs is None:
        from repro_torch.sharding import rules
        specs = rules.param_specs(cfg, mesh)
    return specs


def _is_expert(name: str) -> bool:
    return "/moe/w_" in name and "shared" not in name


def compute_spec(name: str, spec) -> tuple:
    """The part of a stored leaf's spec that the compute copy gathers:
    all of it, but for the vocab tables (their vocab stays split over
    ``model``: the logits are vocab-parallel) and the routed experts
    (split over ``model``: expert parallelism), whose ``embed`` dim alone
    is gathered (over ``data``), as the reference lays them out."""
    if name in ("embed/tokens", "unembed") or _is_expert(name):
        return tuple(None if e == "model" else e for e in spec)
    return tuple(spec)


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
                causal: bool = True, factors=None, comp_len=None,
                enc_out=None):
    """Residual block: norm -> attention, MLA or a recurrent mixer -> (+)
    [norm -> cross-attention -> (+)] [norm -> mlp/moe -> (+)].  ``rope`` is
    the (cos, sin) of ``positions`` at the mixer's rotary width (None
    without RoPE).  A cross-attention layer attends the cache's ``xk``/
    ``xv`` where it holds them, else the K/V of ``enc_out`` (returned in
    the new cache when asked).  Returns (x, new_cache_dict_or_None); a
    recurrent mixer given a cache writes its new state into it and returns
    it."""
    h = L.apply_norm(cfg, p, "norm1", x)
    if spec.mixer in _RECURRENT:
        mix, new_cache = _RECURRENT[spec.mixer](
            cfg, p, h, cache=cache, return_cache=return_cache)
    elif spec.mixer == "mla":
        mix, new_cache = mla_mod.mla_block(
            cfg, p, h, positions=positions, rope=rope,
            cache=cache if cache and "ckv" in cache else None,
            write_pos=write_pos, return_cache=return_cache)
    elif spec.mixer == "attn":
        c = None
        if cache is not None and "k" in cache:
            c = L.KVCache(cache["k"], cache["v"])
        mix, kv = _attn_with_cache(cfg, spec, p, h, positions=positions,
                                   rope=rope, cache=c, write_pos=write_pos,
                                   return_cache=return_cache, causal=causal,
                                   factors=factors, comp_len=comp_len)
        new_cache = {"k": kv.k, "v": kv.v} if kv is not None else None
    else:
        raise ValueError(spec.mixer)
    if cfg.post_norms:
        mix = L.apply_norm(cfg, p, "norm1_post", mix)
    if cfg.parallel_block and spec.ffn != "none":
        return x + (_ffn(cfg, spec, p, h) + mix), new_cache
    x = x + mix
    if spec.cross_attn:
        hx = L.apply_norm(cfg, p, "norm_x", x)
        if cache is not None and "xk" in cache:
            enc_kv = L.KVCache(cache["xk"], cache["xv"])
        elif enc_out is None:
            raise ValueError("a cross-attention layer needs enc_out or a "
                             "cache holding xk/xv")
        else:
            enc_kv = L.encode_cross_kv(cfg, p, enc_out)
        if new_cache is not None:
            new_cache = {**new_cache, "xk": enc_kv.k, "xv": enc_kv.v}
        x = x + L.cross_attn_block(cfg, p, hx, enc_kv)
    if spec.ffn != "none":
        ff = _ffn(cfg, spec, p, L.apply_norm(cfg, p, "norm2", x))
        if cfg.post_norms:
            ff = L.apply_norm(cfg, p, "norm2_post", ff)
        x = x + ff
    return x, new_cache


_RECURRENT = {"rglru": rec.rglru_block, "mlstm": rec.mlstm_block,
              "slstm": rec.slstm_block}


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
            s = k.shape[1]
            if spec.window is not None and spec.window < s:
                # the last window rows in ring order (slot p % window holds
                # position p), the ring a decode at write_pos s continues
                w = spec.window
                kv = L.KVCache(torch.roll(k[:, -w:], s % w, 1),
                               torch.roll(v[:, -w:], s % w, 1))
            else:
                kv = L.KVCache(k, v)
    elif (spec.window is not None and cache.k.shape[1] <= spec.window
          and not factors):
        # a window holding the whole cache with factors (max_seq <= window:
        # the layer is full-context and swaps) decodes through them below
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
                ropes, cache, write_pos, return_cache: bool, causal: bool = True,
                kv_factors=None, comp_len=None, enc_out=None):
    """Prelude layers, the repeated pattern group (a loop over periods on
    views of the stacked leaves) and the remainder layers.  ``ropes`` maps
    a mixer to its RoPE tables (``rope_tables``); ``enc_out`` is the
    encoder output the cross-attention layers attend (whisper)."""
    has_cache = cache is not None
    has_f = kv_factors is not None
    collect = return_cache and not has_cache

    def run(x, spec, p, c, f):
        return apply_layer(cfg, spec, p, x, positions=positions,
                           rope=ropes.get(spec.mixer),
                           cache=c,
                           write_pos=write_pos, return_cache=return_cache,
                           causal=causal, factors=f, comp_len=comp_len,
                           enc_out=enc_out)

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

def rope_tables(cfg: ModelCfg, positions: torch.Tensor) -> dict:
    """The (cos, sin) tables of ``positions`` for each mixer of the stack:
    attention ropes ``head_dim`` columns (when ``use_rope``), MLA its
    ``qk_rope_dim`` columns always (as the reference's ``mla_block``)."""
    mixers = {spec.mixer for spec in cfg.layer_specs()}
    ropes = {}
    if "attn" in mixers and cfg.use_rope:
        ropes["attn"] = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if "mla" in mixers:
        ropes["mla"] = L.rope_tables(positions, cfg.mla.qk_rope_dim,
                                     cfg.rope_theta)
    return ropes


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    cache: Optional[dict]


def _vocab_parallel(mesh, vocab: int) -> bool:
    return (mesh is not None and "model" in mesh.axis_names
            and vocab % mesh.size("model") == 0)


def embed_tokens(cfg, params, tokens):
    """The token embeddings of this rank's ``tokens``.  Vocab-parallel
    under a mesh (the reference's ``shard_map``): each model shard gathers
    the rows it holds, masked to [lo, lo + V/model), and a (B, S, D) psum
    over ``model`` combines them."""
    table = params["embed/tokens"]
    mesh = A.get_mesh()
    if _vocab_parallel(mesh, cfg.vocab):
        vloc = table.shape[0]
        lo = mesh.index("model") * vloc
        local = torch.clamp(tokens - lo, 0, vloc - 1)
        mask = ((tokens >= lo) & (tokens < lo + vloc))[..., None]
        vals = table[local].to(_act_dtype(cfg))
        x = A.psum(torch.where(mask, vals, vals.new_zeros(())), "model", mesh)
    else:
        x = table[tokens].to(_act_dtype(cfg))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def encoder_forward(cfg: ModelCfg, params: dict,
                    enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder: the stub frontend's frame embeddings (B, S_enc, D)
    plus sinusoidal positions, then the bidirectional stack of
    ``enc_layers`` dense layers (no RoPE; non-causal, so the plain
    attention) and ``enc/final_norm``."""
    dt = _act_dtype(cfg)
    x = enc_embeds.to(dt)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                   device=x.device).to(dt)[None]
    enc_cfg = cfg.with_(use_rope=False)
    positions = torch.arange(x.shape[1], device=x.device)
    stack = sub(params, "enc/layers/p0/")
    for t in range(cfg.encdec.enc_layers):
        x, _ = apply_layer(enc_cfg, ENC_SPEC, {k: w[t] for k, w in stack.items()},
                           x, positions=positions, rope=None, cache=None,
                           write_pos=0, return_cache=False, causal=False)
    return L.apply_norm(cfg, sub(params, "enc/"), "final_norm", x)


def forward(cfg: ModelCfg, params: dict, tokens: torch.Tensor, *,
            cache: Optional[dict] = None, write_pos: int = 0,
            img_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            return_cache: bool = False, kv_factors: Optional[dict] = None,
            comp_len: Optional[torch.Tensor] = None,
            last_only: bool = False) -> ForwardOut:
    """tokens: (B, S).  Decode: S == 1 with a populated cache.

    ``img_embeds`` (B, N_img, D) (VLM): projected by ``vlm/proj`` and put
    before the token embeddings; the positions count the image rows.
    ``enc_embeds`` (B, S_enc, D) (enc-dec): run through
    ``encoder_forward`` for the cross-attention layers; the decoder adds
    sinusoidal encodings of its positions.  ``kv_factors``/``comp_len``
    (serving only): the per-layer rank-r KV factors of
    ``cache.build_kv_factors`` plus the per-slot compressed prefix length.
    ``last_only`` computes the logits of the last position alone, (B, 1,
    V): at S = 32768 the full (B, S, V) logits would be 10 GB.  Logits stay
    in the activation dtype, as in the reference.

    Under an active mesh the inputs are the global batch and the rank
    computes its rows of it; the logits are its (B_local, S, V/model)
    block."""
    mesh = A.get_mesh()
    if mesh is not None:
        n = tokens.shape[0]
        tokens, img_embeds, enc_embeds = (
            None if t is None else A.local_rows(mesh, t)
            for t in (tokens, img_embeds, enc_embeds))
        with A.global_batch(n):
            return _forward(cfg, params, tokens, cache=cache,
                            write_pos=write_pos, img_embeds=img_embeds,
                            enc_embeds=enc_embeds, return_cache=return_cache,
                            kv_factors=kv_factors, comp_len=comp_len,
                            last_only=last_only)
    return _forward(cfg, params, tokens, cache=cache, write_pos=write_pos,
                    img_embeds=img_embeds, enc_embeds=enc_embeds,
                    return_cache=return_cache, kv_factors=kv_factors,
                    comp_len=comp_len, last_only=last_only)


def _forward(cfg, params, tokens, *, cache, write_pos, img_embeds,
             enc_embeds, return_cache, kv_factors, comp_len, last_only):
    dt = _act_dtype(cfg)
    x = embed_tokens(cfg, params, tokens)
    if cfg.vlm is not None and img_embeds is not None:
        img = img_embeds.to(dt) @ params["vlm/proj"].to(dt)
        x = torch.cat([img, x], dim=1)
    dev = x.device
    # With a cache the tokens sit at write_pos onwards (the reference's
    # single-token decode position; it numbers a multi-token chunk from 0,
    # which only its token-by-token prefill never meets).  RoPE tables are
    # computed once here, not in every layer.
    start = int(write_pos) if cache is not None else 0
    positions = torch.arange(start, start + x.shape[1], device=dev)
    enc_out = None
    if cfg.encdec is not None:
        if enc_embeds is not None:
            enc_out = encoder_forward(cfg, params, enc_embeds)
        x = x + L.sinusoidal_at(positions, cfg.d_model).to(dt)[None]
    x, new_cache = apply_stack(cfg, params, x, positions=positions,
                               ropes=rope_tables(cfg, positions),
                               cache=cache, write_pos=write_pos,
                               return_cache=return_cache,
                               kv_factors=kv_factors, comp_len=comp_len,
                               enc_out=enc_out)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(cfg, params, "final_norm", x)
    dt = x.dtype
    # vocab-parallel logits: each model rank's block of the vocab, from the
    # same x (its cotangent is the sum of the blocks')
    x = A.enter(x, "model") if _vocab_parallel(A.get_mesh(), cfg.vocab) else x
    if cfg.tie_embeddings:
        logits = x @ params["embed/tokens"].to(dt).T
    else:
        logits = x @ params["unembed"].to(dt)
    return ForwardOut(logits, new_cache)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  final_softcap: float = 0.0, *, mesh=None,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Masked mean cross-entropy; labels < 0 are ignored (padding).  Logits
    arrive in the activation dtype and are upcast (and softcapped) here, so
    the cotangent leaving is in that dtype, as in the reference.

    Under a mesh (``mesh``, else the active one) ``logits`` is this rank's
    (B_local, S, V/model) block (a whole (B_local, S, V) where ``vocab``
    does not split over ``model``) and ``labels`` its rows: the vocab-parallel
    form (Megatron's, the reference's ``shard_map``) takes a local f32
    logsumexp, all-gathers the (B, S) log-sum-exps over ``model`` and
    psums the gold logit its shard owns; the mean is over the global batch
    (``sum(nll * mask)`` and ``sum(mask)`` summed over the batch axes), the
    same on every rank."""
    mesh = A.get_mesh() if mesh is None else mesh
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lg = L.softcap(logits.float(), final_softcap)
    if mesh is not None and _vocab_parallel(
            mesh, vocab or logits.shape[-1] * mesh.size("model")):
        vloc = lg.shape[-1]
        lo = mesh.index("model") * vloc
        lse = A.all_gather(torch.logsumexp(lg, dim=-1)[None], "model", 0, mesh)
        logz = torch.logsumexp(lse, dim=0)
        local = torch.clamp(safe - lo, 0, vloc - 1)
        g = torch.gather(lg, -1, local[..., None])[..., 0]
        owned = (safe >= lo) & (safe < lo + vloc)
        gold = A.psum(torch.where(owned, g, g.new_zeros(())), "model", mesh)
    else:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    if mesh is None:
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    ba = A.batch_axes_of(mesh)
    count = A.all_reduce(torch.sum(mask), mesh, ba) if ba else torch.sum(mask)
    total = A.psum(torch.sum(nll), ba, mesh) if ba else torch.sum(nll)
    return total / torch.clamp(count, min=1)


def loss_fn(cfg: ModelCfg, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"},
    (B, S) integer tensors, and the optional ``img_embeds`` / ``enc_embeds``
    of ``forward``) under ``params`` (cast for compute by the caller).  A
    VLM's image positions, put before the text, carry label -1."""
    out = forward(cfg, params, batch["tokens"],
                  img_embeds=batch.get("img_embeds"),
                  enc_embeds=batch.get("enc_embeds"))
    labels = batch["labels"]
    mesh = A.get_mesh()
    if mesh is not None:
        labels = A.local_rows(mesh, labels)
    if cfg.vlm is not None:
        pad = labels.new_full(labels.shape[:1] + (cfg.vlm.num_image_tokens,), -1)
        labels = torch.cat([pad, labels], dim=1)
    return cross_entropy(out.logits, labels, cfg.final_softcap,
                         vocab=cfg.vocab)
