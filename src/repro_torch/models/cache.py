"""Decode-cache construction: shapes, dtypes and byte accounting (port of
``repro/models/cache.py``).

Cache structure mirrors the stack: {"pre": (...), "scan": (tree_p0, ...),
"rem": (...)} — scan leaves carry a leading n_scan_periods dim.  Attention
layers hold (B, S_c, KV, hd) bf16 K/V (S_c = window for local layers);
recurrent layers hold O(1) state (``STATE_LEAVES``, no seq axis), which
``reset_slot_state`` returns to the zeros ``build_cache`` gives for a slot's
new tenant.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.device import resolve_device


# the recurrent mixers' state leaves (rglru: h, conv; mlstm: c, n, conv;
# slstm: h, c, n): O(1) in sequence length, no seq axis
STATE_LEAVES = ("h", "conv", "c", "n")


def _layer_cache_defs(cfg: ModelCfg, spec: LayerSpec, batch: int, seq: int):
    """dict name -> (shape, dtype) for one layer."""
    kv_dt = torch.bfloat16
    d = {}
    if spec.mixer == "attn":
        s_c = min(seq, spec.window) if spec.window else seq
        d["k"] = ((batch, s_c, cfg.n_kv_heads, cfg.head_dim), kv_dt)
        d["v"] = ((batch, s_c, cfg.n_kv_heads, cfg.head_dim), kv_dt)
    elif spec.mixer == "mla":
        m = cfg.mla
        d["ckv"] = ((batch, seq, m.kv_lora_rank), kv_dt)
        d["kr"] = ((batch, seq, m.qk_rope_dim), kv_dt)
    elif spec.mixer == "rglru":
        dr = cfg.rnn.d_rnn or cfg.d_model
        d["h"] = ((batch, dr), torch.float32)
        d["conv"] = ((batch, cfg.rnn.conv_width - 1, dr), kv_dt)
    elif spec.mixer == "mlstm":
        di = int(cfg.rnn.mlstm_proj_factor * cfg.d_model)
        hd = di // cfg.n_heads
        d["c"] = ((batch, cfg.n_heads, hd, hd), torch.float32)
        d["n"] = ((batch, cfg.n_heads, hd), torch.float32)
        d["conv"] = ((batch, cfg.rnn.conv_width - 1, di), kv_dt)
    elif spec.mixer == "slstm":
        d["h"] = ((batch, cfg.d_model), torch.float32)
        d["c"] = ((batch, cfg.d_model), torch.float32)
        d["n"] = ((batch, cfg.d_model), torch.float32)
    if spec.cross_attn:
        d["xk"] = ((batch, cfg.encdec.enc_seq, cfg.n_kv_heads, cfg.head_dim),
                   kv_dt)
        d["xv"] = ((batch, cfg.encdec.enc_seq, cfg.n_kv_heads, cfg.head_dim),
                   kv_dt)
    return d


def _build_layer_trees(cfg: ModelCfg, defs_fn: Callable, make: Callable) -> dict:
    """Shared pre/scan/rem scaffolding: ``defs_fn(spec) -> {name: (shape,
    dtype)}`` per layer; scan-group leaves get the leading n_scan_periods
    dim.  build_cache and build_kv_factors both use this, so their trees
    cannot drift structurally."""
    def layer_tree(spec, lead=None):
        return {k: make(((lead,) if lead is not None else ()) + shape, dt)
                for k, (shape, dt) in defs_fn(spec).items()}

    pre = tuple(layer_tree(spec) for spec in cfg.prelude)
    scan = tuple(layer_tree(spec, lead=cfg.n_scan_periods)
                 for spec in cfg.pattern) if cfg.n_scan_periods else None
    rem = tuple(layer_tree(cfg.pattern[j % cfg.period])
                for j in range(cfg.n_remainder))
    return {"pre": pre, "scan": scan, "rem": rem}


def _zeros(device):
    dev = resolve_device(device)
    return lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)


def build_cache(cfg: ModelCfg, batch: int, seq: int, *, device=None) -> dict:
    """Zero-filled decode cache on ``device``."""
    return _build_layer_trees(
        cfg, lambda spec: _layer_cache_defs(cfg, spec, batch, seq),
        _zeros(device))


def abstract_cache(cfg: ModelCfg, batch: int, seq: int) -> dict:
    """The cache ``build_cache`` gives, as meta tensors: the reference's
    leaf names, shapes and dtypes, nothing allocated (the dry run's
    stand-ins, as the reference's ``ShapeDtypeStruct`` cache)."""
    return _build_layer_trees(
        cfg, lambda spec: _layer_cache_defs(cfg, spec, batch, seq),
        lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"))


def _factor_defs(cfg: ModelCfg, spec: LayerSpec, batch: int, seq: int,
                 rank: int) -> dict:
    """Factored-KV leaf defs for one layer — only full-context attention
    layers are swappable; factors stay f32; ``us`` rows at or beyond a
    slot's ``comp_len`` are zero by construction."""
    if spec.mixer != "attn" or (spec.window is not None and spec.window < seq):
        return {}
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k_us": ((batch, kv, seq, rank), torch.float32),
        "k_vt": ((batch, kv, rank, hd), torch.float32),
        "v_us": ((batch, kv, seq, rank), torch.float32),
        "v_vt": ((batch, kv, rank, hd), torch.float32),
    }


def build_kv_factors(cfg: ModelCfg, batch: int, seq: int, rank: int, *,
                     device=None) -> dict:
    """Factored-KV tree mirroring ``build_cache``: per eligible layer
    {k_us, k_vt, v_us, v_vt} (zeros until a slot is swapped in), other
    layers an empty dict."""
    return _build_layer_trees(
        cfg, lambda spec: _factor_defs(cfg, spec, batch, seq, rank),
        _zeros(device))


def reset_slot_state(cache: dict, slot: int) -> None:
    """Zero ``slot``'s batch row of every recurrent-state leaf, in place:
    the values ``build_cache`` gives, so a slot's next tenant starts from a
    fresh slot's state.  Leaves with a seq axis are left alone."""
    for group in ("pre", "scan", "rem"):
        for layer in cache[group] or ():
            for name, leaf in layer.items():
                if name in STATE_LEAVES:
                    (leaf[:, slot] if group == "scan" else leaf[slot]).zero_()


def grow_cache(cache: dict, extra: int, cfg: ModelCfg) -> dict:
    """A copy of ``cache`` (of ``cfg``) with the seq axis of every KV-ish
    leaf padded by ``extra`` empty rows (write-then-attend decode needs
    write_pos < capacity).  Other leaves (the recurrent state, the
    cross-attention ``xk``/``xv``) are copied unchanged, so a decode on the
    copy, which writes its state in place, leaves ``cache`` as it was.

    A windowed layer's k/v that already hold ``window`` rows (the ring
    ``make_prefill_step`` leaves past the window, in ring order) are copied
    unpadded, so a decode at any ``write_pos`` takes the ring branch; the
    reference pads them too, and its decode then overruns them."""
    def pad(name, leaf, window):
        if name in ("k", "v"):
            axis = leaf.ndim - 3
            if window is not None and leaf.shape[axis] >= window:
                return leaf.clone()
        elif name in ("ckv", "kr"):
            axis = leaf.ndim - 2
        else:
            return leaf.clone()
        widths = [0, 0] * (leaf.ndim - 1 - axis) + [0, extra]
        return F.pad(leaf, widths)

    def tree(layers, specs):
        return tuple({k: pad(k, v, spec.window) for k, v in layer.items()}
                     for layer, spec in zip(layers, specs))

    rem = [cfg.pattern[j % cfg.period] for j in range(cfg.n_remainder)]
    return {"pre": tree(cache["pre"], cfg.prelude),
            "scan": (tree(cache["scan"], cfg.pattern)
                     if cache["scan"] is not None else None),
            "rem": tree(cache["rem"], rem)}


def cache_bytes(cfg: ModelCfg, batch: int, seq: int) -> int:
    total = 0
    for spec in cfg.layer_specs():
        for shape, dt in _layer_cache_defs(cfg, spec, batch, seq).values():
            n = 1
            for s in shape:
                n *= s
            total += n * dt.itemsize
    return total


def kv_stream_bytes(cfg: ModelCfg, seq: int, *, rank: int = None,
                    tail_rows: int = None) -> int:
    """Worst-case swappable-KV bytes ONE stream holds live at history length
    ``seq``: full-context attention k/v only.  Dense mode (``rank=None``):
    every row bf16.  Compressed: at most ``tail_rows`` dense rows plus f32
    factors (us (seq, r) + vt (r, hd); ``serve.kv_compress.factor_bytes``)."""
    total = 0
    for spec in cfg.layer_specs():
        if spec.mixer != "attn" or (spec.window is not None
                                    and spec.window < seq):
            continue
        per_head_rows = cfg.head_dim * torch.bfloat16.itemsize
        if rank is None:
            rows = seq
            fact = 0
        else:
            if tail_rows is None:
                raise ValueError("compressed kv_stream_bytes needs "
                                 "tail_rows (threshold + prefill chunk)")
            rows = min(seq, tail_rows)
            fact = (seq * rank + rank * cfg.head_dim) * 4
        total += 2 * cfg.n_kv_heads * (rows * per_head_rows + fact)
    return total
