"""Recurrent mixers: RG-LRU (Griffin / recurrentgemma), mLSTM and sLSTM
(xLSTM) (port of ``repro/models/recurrent.py``), in plain PyTorch on tensors
with the reference's function names and formulas.

Numerics as in the reference (its documented deviations, DESIGN.md §8):
  * mLSTM uses sigmoid input/forget gates, computed in the chunked parallel
    form (intra-chunk quadratic, inter-chunk recurrent state).  The chunk
    rule is the reference's: ``cs = min(chunk, s)``, and one chunk of ``s``
    when ``s % cs``, so a ragged prompt runs as one quadratic chunk.
  * RG-LRU: ``a_t = exp(-8 softplus(lambda) sigmoid(r_t))``, ``h_t = a_t
    h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``, by a log-depth scan over the
    sequence (Hillis-Steele with the reference's combine; the reference's
    ``jax.lax.associative_scan`` pairs the steps in another order, so f32
    results differ in the last bits) and one direct step for a cached
    one-token decode.
  * sLSTM keeps the per-head block-diagonal recurrence R and runs a time
    loop, one step a token (eager: a dozen small operators a step).  Its
    starting normalizer ``n`` is ones without a cache and the cache's
    (zeros when built) with one, as in the reference.

Every block takes ``cache`` (a dict of the layer's state leaves, or None)
and ``return_cache``.  With a cache the new state is written back INTO the
cache's tensors (``copy_``; the leaves may be views of a slot's rows of the
serving pool) and the same dict is returned; the reference returns new
arrays.  Without one, fresh tensors are returned (``return_cache``) and
nothing is written in place, so autograd can differentiate the block.  A
cache leaf keeps its dtype: the bf16 ``conv`` leaf rounds the state that
f32 activations write into it, where the reference's pytree leaf turns f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation

_RG_C = 8.0  # Griffin's fixed recurrence sharpness


def _state_out(cache, new: dict, return_cache: bool):
    """With a cache, copy each new state into its leaf (in place) and return
    the cache; without one, the new states when asked for."""
    if cache is None:
        return new if return_cache else None
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (width W), shift-and-add form
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, conv_state=None):
    """x: (B, S, C); w: (W, C) depthwise; conv_state: (B, W-1, C) previous
    inputs (None: zeros).  Returns (y, new_state), both in x's dtype."""
    width = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+W-1, C)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return y, xp[:, -(width - 1):]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0):
    """h_t = a_t * h_{t-1} + b_t for every t; a, b: (B, S, C) f32, h0: (B,
    C) or None.  Hillis-Steele over the sequence axis with the reference's
    combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``: ceil(log2 S)
    steps, each pairing position t with t - d.  The products of ``a`` stay
    partial products of at most S factors that the combine folds into
    ``b`` at once, so nothing underflows the way ``cumprod(a)`` does."""
    if h0 is not None:
        # fold the initial state into the first step, as the reference does
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_block(cfg, p: dict, x: torch.Tensor, *, cache, return_cache: bool):
    """Griffin recurrent block: lin_in -> conv -> RG-LRU -> gate -> lin_out.
    Cache leaves: ``h`` (B, Dr) f32, ``conv`` (B, W-1, Dr)."""
    dt = x.dtype
    u = x @ p["rnn/w_in"].to(dt)                    # (B, S, Dr)
    gate = x @ p["rnn/w_gate_in"].to(dt)
    conv_state = cache.get("conv") if cache is not None else None
    u, new_conv = causal_conv1d(u, p["rnn/conv_w"].to(dt), conv_state)

    uf = u.float()
    r = torch.sigmoid(uf @ p["rnn/w_a"].float())
    i = torch.sigmoid(uf @ p["rnn/w_x"].float())
    log_a = -_RG_C * F.softplus(p["rnn/lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)

    h0 = cache.get("h") if cache is not None else None
    if x.shape[1] == 1 and cache is not None:
        new_h = a[:, 0] * h0 + b[:, 0]              # the direct decode step
        hs = new_h[:, None]
    else:
        hs = _rglru_scan(a, b, h0)
        new_h = hs[:, -1]

    out = hs.to(dt) * activation("gelu", gate)
    out = out @ p["rnn/w_out"].to(dt)
    return out, _state_out(cache, {"h": new_h, "conv": new_conv}, return_cache)


# ---------------------------------------------------------------------------
# mLSTM (chunked matrix-memory linear attention)
# ---------------------------------------------------------------------------

def _mlstm_chunk(q, k, v, li, lf_c, state):
    """One chunk.  q, k, v: (B, H, T, hd); li: (B, H, T) log input gate;
    lf_c: (B, H, T) cumulative log forget within the chunk (inclusive);
    state: (C (B, H, hd, hd), n (B, H, hd)).  Returns (h, new_state)."""
    c_prev, n_prev = state
    t = q.shape[2]
    # intra-chunk decay w_ij = exp(lf_i - lf_j + li_j), j <= i.  The upper
    # triangle is masked before the exp (the reference masks after it):
    # the same values, and no inf there for a gradient to multiply by 0.
    d = lf_c[:, :, :, None] - lf_c[:, :, None, :] + li[:, :, None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    w = torch.exp(d.masked_fill(~mask, -math.inf))
    scores = (q @ k.transpose(-1, -2)) * w
    num_intra = scores @ v
    den_intra = w @ k
    # inter-chunk: decay from the chunk's start
    decay = torch.exp(lf_c)[..., None]              # (B, H, T, 1)
    num_inter = (q @ c_prev) * decay
    den_inter = n_prev[:, :, None, :] * decay
    num = num_intra + num_inter
    den = (q * (den_intra + den_inter)).sum(-1)
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    # state to the chunk's end: decay exp(lf_T - lf_j + li_j)
    w_end = torch.exp(lf_c[:, :, -1:] - lf_c + li)  # (B, H, T)
    f_end = torch.exp(lf_c[:, :, -1])
    kw = k * w_end[..., None]
    c_new = f_end[..., None, None] * c_prev + kw.transpose(-1, -2) @ v
    n_new = f_end[..., None] * n_prev + kw.sum(2)
    return h, (c_new, n_new)


def mlstm_block(cfg, p: dict, x: torch.Tensor, *, cache, return_cache: bool,
                chunk: int = 256):
    """xLSTM mLSTM block: up-projection (factor 2) -> conv -> q/k/v and gates
    -> chunked matrix-memory attention -> gated down-projection.  Cache
    leaves: ``c`` (B, H, hd, hd) f32, ``n`` (B, H, hd) f32, ``conv`` (B,
    W-1, Di).

    The reference scans the chunks with ``lax.scan``, or unrolls them in
    Python under ``cfg.unroll_scans`` (its cost-probe mode): both compute
    the same chunks in the same order, which is this loop's."""
    dt = x.dtype
    b, s, d = x.shape
    di = int(cfg.rnn.mlstm_proj_factor * d)
    nh = cfg.n_heads
    hd = di // nh

    u = x @ p["mlstm/w_up"].to(dt)                  # (B, S, Di)
    z = x @ p["mlstm/w_z"].to(dt)                   # gate branch
    conv_state = cache.get("conv") if cache is not None else None
    uc, new_conv = causal_conv1d(u, p["mlstm/conv_w"].to(dt), conv_state)
    uc = activation("silu", uc)

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)   # (B, H, S, hd)

    q = heads(uc @ p["mlstm/wq"].to(dt)).float()
    k = heads(uc @ p["mlstm/wk"].to(dt)).float()
    v = heads(u @ p["mlstm/wv"].to(dt)).float()
    q = q / math.sqrt(hd)

    uf = u.float()
    li = F.logsigmoid(uf @ p["mlstm/w_ig"].float()).transpose(1, 2)  # (B,H,S)
    lf = F.logsigmoid(uf @ p["mlstm/w_fg"].float()).transpose(1, 2)

    if cache is not None:
        state = (cache["c"].float(), cache["n"].float())
    else:
        state = (x.new_zeros((b, nh, hd, hd), dtype=torch.float32),
                 x.new_zeros((b, nh, hd), dtype=torch.float32))

    cs = min(chunk, s)
    if s % cs:
        cs = s
    hs = []
    for lo in range(0, s, cs):
        sl = slice(lo, lo + cs)
        hc, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 li[:, :, sl], torch.cumsum(lf[:, :, sl], -1),
                                 state)
        hs.append(hc)
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=2)
    c_new, n_new = state

    out = h.transpose(1, 2).reshape(b, s, di).to(dt)
    out = out * activation("silu", z)
    out = out @ p["mlstm/w_down"].to(dt)
    return out, _state_out(cache, {"c": c_new, "n": n_new, "conv": new_conv},
                           return_cache)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, block-diagonal recurrence, time loop)
# ---------------------------------------------------------------------------

def slstm_block(cfg, p: dict, x: torch.Tensor, *, cache, return_cache: bool):
    """xLSTM sLSTM block.  Cache leaves: ``h``, ``c``, ``n`` (B, D) f32."""
    dt = x.dtype
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh

    # input contributions for the 4 gates: (B, S, 4D)
    wx = (x @ p["slstm/w_x"].to(dt)).float()
    r = p["slstm/r"].float()                        # (H, hd, 4hd)

    if cache is not None:
        h, c, n = (cache[k].float() for k in ("h", "c", "n"))
    else:
        h = x.new_zeros((b, d), dtype=torch.float32)
        c = x.new_zeros((b, d), dtype=torch.float32)
        n = x.new_ones((b, d), dtype=torch.float32)

    hs = []
    for t in range(s):
        rec = torch.einsum("bkh,khg->bkg", h.reshape(b, nh, hd), r)
        g = wx[:, t] + rec.reshape(b, 4 * d)
        zg, ig, fg, og = g.chunk(4, dim=-1)
        zg = torch.tanh(zg)
        ig = torch.sigmoid(ig)
        fg = torch.sigmoid(fg)
        og = torch.sigmoid(og)
        c = fg * c + ig * zg
        n = fg * n + ig
        h = og * (c / torch.clamp(n, min=1e-6))
        hs.append(h)

    out = torch.stack(hs, dim=1).to(dt)             # (B, S, D)
    out = out @ p["slstm/w_out"].to(dt)
    return out, _state_out(cache, {"h": h, "c": c, "n": n}, return_cache)
