"""Kernel 1: SHGEMM, C_f32 = A_f32 @ B_lowp with the split done in-kernel.

Port of the Pallas TPU kernel ``_shgemm_kernel`` (``repro/kernels/shgemm.py``,
entry ``shgemm_pallas``) as hand-written CUDA C++ for ``sm_90a``
(``csrc/shgemm.cu`` over ``csrc/shgemm_common.cuh``): each (bm, bn) output
tile loops over K in-block, splits the f32 A tile in registers into
``terms`` bf16/fp16 parts, runs one ``mma.sync`` per term, and every ``bk``
of K adds the tile's per-term partials into the f32 accumulator with RN f32
adds.  The per-element summation order depends on ``bk`` alone, so results
are bit-identical across block shapes that share ``bk``.

``shgemm_pallas`` keeps the reference's name: in the port it means the
hand-written Hopper kernel.  It launches the kernel for a CUDA tensor and
runs the plain PyTorch version (``shgemm_plain``) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import shgemm_ref

# (bm, bn): the kernel's instantiations (csrc/shgemm_common.cuh); bk is any
# multiple of the 32-deep shared-memory stage.
SUPPORTED_BM = (32, 64, 128)
SUPPORTED_BN = (32, 64)
STAGE_K = 32
DEFAULT_BM = 128
DEFAULT_BN = 64
DEFAULT_BK = 256

# Kernel launches made by ``shgemm_pallas`` in this process.
launches = 0


def check_blocks(bm: int, bn: int, bk: int) -> None:
    if bm not in SUPPORTED_BM or bn not in SUPPORTED_BN or bk <= 0 or bk % STAGE_K:
        raise ValueError(
            f"blocks {(bm, bn, bk)} unsupported: bm in {SUPPORTED_BM}, "
            f"bn in {SUPPORTED_BN}, bk a positive multiple of {STAGE_K}")


def check_launch_operand(x: torch.Tensor, name: str, device: torch.device) -> None:
    """What the CUDA kernels take: contiguous, 16-byte aligned, on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Static shared memory of one block (the counterpart of the reference's
    ``vmem_bytes``): the f32 A stage and the 16-bit B stage, each 32 deep and
    padded by 8 along K.  ``bk`` does not enter: K is staged 32 at a time and
    ``bk`` only sets how often partials flush into the accumulator.  Kernel
    2's dynamic shared memory is ``shgemm_fused.smem_bytes``."""
    check_blocks(bm, bn, bk)
    return bm * (STAGE_K + 8) * 4 + bn * (STAGE_K + 8) * 2


def shgemm_plain(a: torch.Tensor, b: torch.Tensor, terms: int = 2) -> torch.Tensor:
    """The kernel's function in plain PyTorch: split A, upcast each term and
    B to f32 (exact products), ``torch.matmul``, sum with the fp16 scale."""
    return shgemm_ref(a, b, terms)


def _launcher():
    fn = _build.load("shgemm").shgemm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def shgemm_pallas(a: torch.Tensor, b: torch.Tensor, *, bm: int = DEFAULT_BM,
                  bn: int = DEFAULT_BN, bk: int = DEFAULT_BK,
                  terms: int = 2) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n]; A f32, B bf16/fp16, C f32.

    Shapes must be multiples of the block sizes; ``ops.shgemm`` pads
    arbitrary shapes before calling this.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"A must be f32, got {a.dtype}")
    if b.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"B must be bf16/fp16, got {b.dtype}")
    check_blocks(bm, bn, bk)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shapes {(m, k, n)} not divisible by blocks {(bm, bk, bn)}")
    if terms not in (1, 2, 3) or (terms == 3 and b.dtype == torch.float16):
        raise ValueError(f"terms={terms} unsupported for {b.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return shgemm_plain(a, b, terms)
    if a.device.type != "cuda":
        raise ValueError(f"shgemm_pallas runs on CUDA or CPU tensors, got {a.device}")
    check_launch_operand(a, "A", a.device)
    check_launch_operand(b, "B", a.device)
    if m // bm > 65535:
        raise ValueError(f"m={m} needs more than 65535 row blocks of {bm}")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = _launcher()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, bm, bn,
                      bk, terms, int(b.dtype == torch.float16),
                      torch.cuda.current_stream(a.device).cuda_stream,
                      a.device.index or 0)
    if err:
        raise RuntimeError(f"shgemm kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return c
