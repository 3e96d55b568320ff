"""Shared transformer layers: norms, RoPE, blockwise attention, MLP (port of
``repro/models/layers.py``).

Attention is blockwise over query chunks so the (S x S) score matrix never
exists whole.  Activations flow in ``cfg.activation_dtype`` (bf16); softmax
statistics and accumulators are f32.  ``factored_decode_attention`` is the
plain oracle of the factored-decode kernel (``kernels/factored_decode.py``).

The reference's ``sharding.activation.constrain`` calls are no-ops on one
card and are dropped.  Whisper's decoder cross-attention
(``cross_attn_block`` over ``encode_cross_kv``'s encoder K/V) and the
sinusoidal positions of its encoder and decoder are the reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    # (1 + scale) convention so zero-init means identity (same as rmsnorm)
    out = out * (1.0 + scale.float()) + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg, p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}/scale"], p[f"{prefix}/bias"],
                         cfg.norm_eps)
    return rmsnorm(x, p[f"{prefix}/scale"], cfg.norm_eps)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference's formulas op by op in x's dtype (XLA rounds each bf16
    op; ``F.silu`` would round once and differ in ~40 % of bf16 outputs)."""
    if name == "gelu":
        inner = math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x ** 3))
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    return x * (1.0 / (1.0 + torch.exp(-x)))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embedding; positions (..., S)."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions.float()[..., None] * freq  # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, N, head_dim); cos/sin: (S, half) or (B, S, half).  Half-split
    rotation, in f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.ndim == 2:  # (S, half) -> broadcast over batch & heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:              # (B, S, half)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(seq, device=device), dim)


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal encodings (S, dim) f32 at absolute positions (S,): angle
    ``pos / 10000^(2i/dim)``, then ``[sin, cos]``."""
    pos = positions.float()[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=positions.device),
                          2 * i / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Blockwise multi-head attention (GQA), causal / bidirectional / local
# ---------------------------------------------------------------------------

def _chunk_attend(q, k, v, q_pos, kv_pos, *, causal, window, scale, cap):
    """One query chunk vs all kv.  q: (B, H, Cq, hd); k/v: (B, KV, S, hd).
    Returns (B, H, Cq, hd_v) in f32."""
    b, h, cq, hd = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, cq, hd)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale
    scores = softcap(scores, cap)
    mask = torch.ones((cq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(b, h, cq, v.shape[-1])


def attention(q, k, v, *, causal: bool, window: Optional[int], scale: float,
              cap: float = 0.0, q_positions: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              chunk: int = 1024) -> torch.Tensor:
    """q: (B, S_q, H, hd); k/v: (B, S_kv, KV, hd) -> (B, S_q, H, hd).

    Loops over query chunks so peak memory is O(S_kv * chunk), not O(S^2).
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev)
    qt = q.transpose(1, 2)          # (B, H, Sq, hd)
    kt = k.transpose(1, 2)          # (B, KV, Skv, hd)
    vt = v.transpose(1, 2)
    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = sq  # ragged query lengths (smoke shapes): single chunk
    outs = [_chunk_attend(qt[:, :, i:i + chunk], kt, vt,
                          q_positions[i:i + chunk], kv_positions,
                          causal=causal, window=window, scale=scale, cap=cap)
            for i in range(0, sq, chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out.transpose(1, 2).to(q.dtype)


def factored_decode_attention(q, k, v, k_us, k_vt, v_us, v_vt, comp_len, *,
                              write_pos: int, scale: float, cap: float = 0.0):
    """Single-token decode attention over a factored prefix + dense tail: the
    plain oracle of kernel 4.

    Rows [0, comp_len_b) of slot b live only as rank-r factors
    K ~ us_k·vt_k, V ~ us_v·vt_v (the dense rows there are zeroed); rows
    comp_len_b <= i <= write_pos come from the dense cache; one softmax
    spans both.  Prefix scores are (q·vt_k^T)·us_k^T, K never materialized.

    q: (B, 1, H, hd); k/v: (B, S, KV, hd); *_us: (B, KV, S, r) with rows
    >= comp_len[b] zero; *_vt: (B, KV, r, hd); comp_len: (B,) int;
    write_pos: int.  Returns (B, 1, H, hd) in q.dtype; all math f32.
    When no slot is compressed the factored einsums are skipped (the
    reference's ``any_comp`` short-circuit): the result is bit-identical to
    computing them, because their weights are exact zeros.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    qf = q.float().reshape(b, kvh, groups, hd)
    kf = k.float().transpose(1, 2)                     # (B, KV, S, hd)
    vf = v.float().transpose(1, 2)
    comp_len = comp_len.to(q.device)

    s_dense = torch.einsum("bkgd,bksd->bkgs", qf, kf) * scale
    any_comp = bool((comp_len > 0).any())
    if any_comp:
        qv = torch.einsum("bkgd,bkrd->bkgr", qf, k_vt.float())
        s_fact = torch.einsum("bkgr,bksr->bkgs", qv, k_us.float()) * scale
    else:
        s_fact = torch.zeros_like(s_dense)
    idx = torch.arange(skv, dtype=torch.int64, device=q.device)
    prefix = idx[None, :] < comp_len[:, None].long()   # (B, S)
    valid = (idx[None, :] <= int(write_pos)).expand_as(prefix)
    scores = torch.where(prefix[:, None, None], s_fact, s_dense)
    scores = softcap(scores, cap)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)              # (B, KV, G, S)

    w_pre = probs * prefix[:, None, None]
    w_tail = probs * (valid & ~prefix)[:, None, None]
    if any_comp:
        out = torch.einsum("bkgr,bkrd->bkgd",
                           torch.einsum("bkgs,bksr->bkgr", w_pre, v_us.float()),
                           v_vt.float())
    else:
        out = torch.zeros_like(qf)
    out = out + torch.einsum("bkgs,bksd->bkgd", w_tail, vf)
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + cache plumbing)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, KV, hd)
    v: torch.Tensor


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dnh->bsnh") as one (B*S, D) @ (D, N*hd) product."""
    b, s, d = x.shape
    n, hd = w.shape[1], w.shape[2]
    return (x.reshape(b * s, d) @ w.to(x.dtype).reshape(d, n * hd)).reshape(
        b, s, n, hd)


def qkv_project(cfg, p, prefix, x):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    dt = x.dtype
    q = _proj_heads(x, p[f"{prefix}/wq"])
    k = _proj_heads(x, p[f"{prefix}/wk"])
    v = _proj_heads(x, p[f"{prefix}/wv"])
    if cfg.qkv_bias:
        q = q + p[f"{prefix}/bq"].to(dt)
        k = k + p[f"{prefix}/bk"].to(dt)
        v = v + p[f"{prefix}/bv"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm(q, p[f"{prefix}/q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p[f"{prefix}/k_norm"], cfg.norm_eps)
    return q, k, v


def cross_attn_block(cfg, p, x, enc_kv: KVCache):
    """Decoder cross-attention over precomputed encoder K/V (whisper):
    non-causal, through the plain blockwise ``attention``."""
    dt = x.dtype
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q = _proj_heads(x, p["xattn/wq"])
    out = attention(q, enc_kv.k.to(dt), enc_kv.v.to(dt), causal=False,
                    window=None, scale=scale, chunk=cfg.attn_chunk)
    b, sq = out.shape[:2]
    return out.reshape(b, sq, -1) @ p["xattn/wo"].to(dt)


def encode_cross_kv(cfg, p, enc_out) -> KVCache:
    """The encoder output's K/V for one decoder layer's cross-attention."""
    return KVCache(_proj_heads(enc_out, p["xattn/wk"]),
                   _proj_heads(enc_out, p["xattn/wv"]))


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_block(cfg, p, x, prefix="mlp"):
    """Gated MLP (SwiGLU/GeGLU): (D -> F) * act(D -> F) -> D."""
    dt = x.dtype
    gate = x @ p[f"{prefix}/w_gate"].to(dt)
    up = x @ p[f"{prefix}/w_up"].to(dt)
    h = activation(cfg.act, gate) * up
    return h @ p[f"{prefix}/w_down"].to(dt)

