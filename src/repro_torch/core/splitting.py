"""FP32 mantissa splitting for mixed-precision GEMM (paper Eq. 37-40).

Port of ``repro/core/splitting.py``.  Every split is a chain of
round-to-nearest-even casts and exact f32 subtractions, so it matches the
reference bit for bit on any backend, fp16 overflow to inf included.

  * bf16 split: ``a ~ hi + lo``; bf16 shares f32's exponent, so the
    residual needs no rescale.
  * fp16 split (the paper's own Eq. 37-38): ``a ~ hi + lo * 2^-11``; values
    past fp16 range become inf, the paper's §5.1.1 Cauchy failure mode.
  * 3-term bf16 split: ``a ~ hi + mid + lo``, ~24 mantissa bits.
"""

from __future__ import annotations

from typing import Literal

import torch

SplitFormat = Literal["bf16", "fp16"]

# 2^11 scaling from paper Eq. (38): the fp16 residual lives ~11 bits below
# A's exponent and would underflow e5m10 without it.
FP16_SCALE = 2.0**11
FP16_INV_SCALE = 2.0**-11


def split_fp32_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = RN_bf16(a); lo = RN_bf16(a - f32(hi))."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def split_fp32_fp16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper Eq. (37)-(38): a ~ hi + lo * 2^-11 with hi, lo in fp16."""
    a = a.to(torch.float32)
    hi = a.to(torch.float16)
    lo = ((a - hi.to(torch.float32)) * FP16_SCALE).to(torch.float16)
    return hi, lo


def split_fp32_bf16_3(
        a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3-term bf16 split: a ~ hi + mid + lo."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    r1 = a - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def split_fp32(a: torch.Tensor,
               fmt: SplitFormat = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    if fmt == "bf16":
        return split_fp32_bf16(a)
    if fmt == "fp16":
        return split_fp32_fp16(a)
    raise ValueError(f"unknown split format {fmt!r}")


def merge_split(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of split_fp32 (up to the ~0.25-bit residual)."""
    if hi.dtype == torch.float16:
        return hi.to(torch.float32) + lo.to(torch.float32) * FP16_INV_SCALE
    return hi.to(torch.float32) + lo.to(torch.float32)


def split_residual(a: torch.Tensor, fmt: SplitFormat = "bf16") -> torch.Tensor:
    """The A_Delta term of paper Eq. (43): what the 2-term split cannot carry."""
    hi, lo = split_fp32(a, fmt)
    return a.to(torch.float32) - merge_split(hi, lo)
