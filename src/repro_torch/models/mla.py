"""DeepSeek-V2 Multi-head Latent Attention (port of ``repro/models/mla.py``).

Train and prefill (no cache) materialize per-head K/V from the latent and
attend through ``layers.attention``; decode uses the absorbed form: queries
are projected into the kv_lora latent space and attention runs directly
over the (B, S, r) latent cache plus the (B, S, rope) shared rope key, so
the cache is r + rope wide instead of 2·H·hd.  Neither branch reaches the
attention kernels (qk 192 != v 128 here, and the reference calls
``layers.attention`` directly).

Every step keeps the reference's dtype: projections in the activation
dtype, the absorbed scores, softmax and latent output in f32, the latent
output cast back before the up-projection.

Differences from the reference, none of which changes the arithmetic of a
single token:
  * the cached branch writes the latents into the cache IN PLACE and
    returns the same cache dict;
  * it takes a chunk of s >= 1 tokens at ``write_pos``: row i attends
    positions <= write_pos + i (the reference's mask, ``arange <=
    write_pos``, is that of its token-by-token prefill, s = 1);
  * the RoPE tables are built once a forward (``transformer.forward``) and
    passed in as ``rope``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L


def mla_block(cfg, p: dict, x: torch.Tensor, *, positions: torch.Tensor,
              rope, cache, write_pos, return_cache: bool):
    """x: (B, S, D) -> (out (B, S, D), new cache or None).

    ``rope`` is the (cos, sin) of ``positions`` at ``qk_rope_dim``.  With
    ``cache`` ({"ckv": (B, S_c, r), "kr": (B, S_c, rope)}) the S tokens'
    latents land in rows [write_pos, write_pos + S) and the block attends
    the cache (absorbed); without it K/V are materialized, and
    ``return_cache`` returns the chunk's {"ckv", "kr"}."""
    m = cfg.mla
    dt = x.dtype
    h = cfg.n_heads
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    b, s, _ = x.shape

    q = L._proj_heads(x, p["mla/wq"])                  # (B, S, H, nope+rope)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    ckv = L.rmsnorm(x @ p["mla/w_dkv"].to(dt), p["mla/kv_norm"],
                    cfg.norm_eps)                       # (B, S, r)
    krope = x @ p["mla/w_kr"].to(dt)                    # (B, S, rope)
    cos, sin = rope
    q_rope = L.apply_rope(q_rope, cos, sin)
    krope = L.apply_rope(krope[:, :, None, :], cos, sin)[:, :, 0, :]
    w_uk = p["mla/w_uk"].to(dt)                         # (r, H, nope)
    w_uv = p["mla/w_uv"].to(dt)                         # (r, H, v_hd)

    new_cache = None
    if cache is None:
        k = torch.cat([L._proj_heads(ckv, w_uk),
                       krope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)],
                      dim=-1)
        out = L.attention(torch.cat([q_nope, q_rope], dim=-1), k,
                          L._proj_heads(ckv, w_uv), causal=True, window=None,
                          scale=scale, q_positions=positions,
                          kv_positions=positions, chunk=cfg.attn_chunk)
        if return_cache:
            new_cache = {"ckv": ckv, "kr": krope}
    else:
        c_kv, c_kr = cache["ckv"], cache["kr"]
        s_kv = c_kv.shape[1]
        wp = int(write_pos)
        if not 0 <= wp <= s_kv - s:
            raise ValueError(f"write_pos={wp} + {s} rows overruns the latent "
                             f"cache of {s_kv}")
        q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, w_uk)
        c_kv[:, wp:wp + s] = ckv.to(c_kv.dtype)
        c_kr[:, wp:wp + s] = krope.to(c_kr.dtype)
        ckv_all = c_kv.float()
        scores = (torch.einsum("bsnr,btr->bnst", q_lat.float(), ckv_all)
                  + torch.einsum("bsnh,bth->bnst", q_rope.float(),
                                 c_kr.float())) * scale
        t = torch.arange(s_kv, device=x.device)
        valid = t[None, :] <= (wp + torch.arange(s, device=x.device))[:, None]
        scores = torch.where(valid, scores,
                             torch.full_like(scores, L.NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bnst,btr->bsnr", probs, ckv_all)
        out = torch.einsum("bsnr,rnh->bsnh", o_lat.to(dt), w_uv)
        new_cache = cache

    return out.reshape(b, s, -1) @ p["mla/wo"].to(dt), new_cache
