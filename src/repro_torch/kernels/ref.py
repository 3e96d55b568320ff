"""Plain-PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``).

bf16 x bf16 and fp16 x fp16 products are exact in f32, so every
low-precision term is upcast to f32 before ``torch.matmul``: the reference's
``jnp.dot(..., preferred_element_type=f32)``.  A bf16-output matmul would
round each term and lose the correction.  ``flash_attention_ref`` is the
oracle of the causal flash-attention kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.splitting import (FP16_INV_SCALE, split_fp32,
                                        split_fp32_bf16_3)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of two (exactly upcast) operands."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def shgemm_ref(a_f32: torch.Tensor, b_lowp: torch.Tensor,
               terms: int = 2) -> torch.Tensor:
    """C = A_f32 @ B_lowp via the split-term sum (paper Eq. 37-40)."""
    a = a_f32.to(torch.float32)
    if terms == 3:
        if b_lowp.dtype == torch.float16:
            raise ValueError("terms=3 is bf16-only")
        hi, mid, lo = split_fp32_bf16_3(a)
        return dot_f32(hi, b_lowp) + dot_f32(mid, b_lowp) + dot_f32(lo, b_lowp)
    if terms == 1:
        return dot_f32(a.to(b_lowp.dtype), b_lowp)
    fmt = "fp16" if b_lowp.dtype == torch.float16 else "bf16"
    hi, lo = split_fp32(a, fmt)
    main = dot_f32(hi, b_lowp)
    corr = dot_f32(lo, b_lowp)
    if fmt == "fp16":
        return main + corr * FP16_INV_SCALE
    return main + corr


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Plain GQA attention oracle: q (B, S, H, hd), k/v (B, S, KV, hd),
    f32 scores and softmax, the (S, S) matrix materialized."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def sgemm_f64_oracle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The accuracy oracle of paper Fig. 5: inputs widened to f64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def relative_error_fro(c: torch.Tensor, c_ref: torch.Tensor) -> torch.Tensor:
    """||C - C_ref||_F / ||C_ref||_F (paper's RelativeError metric)."""
    c = c.to(c_ref.dtype) if c_ref.dtype == torch.float64 else c
    return torch.linalg.norm(c - c_ref) / torch.linalg.norm(c_ref)
