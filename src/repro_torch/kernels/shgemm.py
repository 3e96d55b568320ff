"""Kernel 1: SHGEMM, C_f32 = A_f32 @ B_lowp with the split done in-kernel.

Port of the Pallas TPU kernel ``_shgemm_kernel`` (``repro/kernels/shgemm.py``,
entry ``shgemm_pallas``) as hand-written CUDA C++ for ``sm_90a``
(``csrc/shgemm.cu`` over ``csrc/shgemm_splitk.cuh``, the main loop it shares
with kernel 2): each (bm, bn) output tile walks its run of K in-block,
splits the f32 A tile in registers into ``terms`` bf16/fp16 parts, runs one
``mma.sync`` per term, and every ``bk`` of K sums the tile's per-term
partials with RN f32 adds.  ``splits`` > 1 cuts K into that many runs of
whole ``bk`` tiles, one per block along the grid's third axis; each writes
its tiles' partial products to a workspace (``workspace_bytes``) and a
second kernel sums them in tile order.  The per-element summation order
depends on ``bk`` alone, so results are bit-identical across (bm, bn,
splits) that share ``bk``, and equal kernel 2's on the same Omega.

``shgemm_pallas`` keeps the reference's name: in the port it means the
hand-written Hopper kernel.  It launches the kernel for a CUDA tensor and
runs the plain PyTorch version (``shgemm_plain``) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import shgemm_ref

# (bm, bn) instantiated in csrc/shgemm_splitk.cuh (``dispatch_tile``), for
# kernels 1 and 2 alike; bk is any multiple of the 32-deep shared-memory
# stage.  At 256 x 32 eight warps share one B stage.
TILES = ((256, 32), (128, 64), (128, 32), (64, 64), (64, 32), (32, 64),
         (32, 32))
STAGE_K = 32
DEFAULT_BM = 128
DEFAULT_BN = 64
DEFAULT_BK = 256
RING = 3           # A stages in flight (csrc/shgemm_splitk.cuh)
MAX_SPLITS = 65535  # the grid's third dimension

# Kernel launches made by ``shgemm_pallas`` in this process, and how many of
# them also launched the split-K reduction.
launches = 0
reductions = 0


def check_blocks(bm: int, bn: int, bk: int) -> None:
    if (bm, bn) not in TILES or bk <= 0 or bk % STAGE_K:
        raise ValueError(
            f"blocks {(bm, bn, bk)} unsupported: (bm, bn) in {TILES}, "
            f"bk a positive multiple of {STAGE_K}")


def check_plan(m: int, n: int, k: int, bm: int, bn: int, bk: int,
               splits: int) -> None:
    """Raise unless (bm, bn, bk, splits) is a launchable plan for the padded
    launch shape (m, n, k)."""
    check_blocks(bm, bn, bk)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shapes {(m, k, n)} not divisible by blocks "
                         f"{(bm, bk, bn)}")
    if (not isinstance(splits, (int, np.integer)) or isinstance(splits, bool)
            or splits < 1 or splits > MAX_SPLITS or (k // bk) % splits):
        raise ValueError(
            f"splits={splits!r} must be an integer in [1, {MAX_SPLITS}] that "
            f"divides the {k // bk} bk tiles of k={k} (bk={bk})")


def check_launch_operand(x: torch.Tensor, name: str, device: torch.device) -> None:
    """What the CUDA kernels take: contiguous, 16-byte aligned, on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of one block (``SplitKSmem`` in csrc/, the
    counterpart of the reference's ``vmem_bytes``): the ring of ``RING`` f32
    A stages and two 16-bit B stages, each 32 deep and padded by 8 along K.
    ``bk`` does not enter: K is staged 32 at a time and ``bk`` only sets how
    often partials are summed.  Kernel 2 adds its column-hash table
    (``shgemm_fused.smem_bytes``)."""
    return RING * bm * (STAGE_K + 8) * 4 + 2 * bn * (STAGE_K + 8) * 2


def workspace_bytes(m: int, n: int, k: int, bk: int, splits: int) -> int:
    """Device memory of the split-K workspace W[k / bk, m, n] (f32) for the
    padded launch shape; none with one split."""
    return 0 if splits == 1 else (k // bk) * m * n * 4


def shgemm_plain(a: torch.Tensor, b: torch.Tensor, terms: int = 2) -> torch.Tensor:
    """The kernel's function in plain PyTorch: split A, upcast each term and
    B to f32 (exact products), ``torch.matmul``, sum with the fp16 scale."""
    return shgemm_ref(a, b, terms)


def _launcher():
    fn = _build.load("shgemm").shgemm_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(bm: int, bn: int, terms: int = 2, lowp=torch.bfloat16,
                  device=None) -> int:
    """Blocks of the kernel's (bm, bn, terms) instantiation that one SM
    holds at once (the CUDA occupancy calculator on the built kernel);
    needs the card."""
    fn = _build.load("shgemm").shgemm_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    n = fn(bm, bn, terms, int(lowp == torch.float16),
           torch.device(device or "cuda").index or 0)
    if n < 0:
        raise RuntimeError(f"no occupancy for kernel 1 at {(bm, bn)}, "
                           f"terms={terms}, {lowp}")
    return n


def shgemm_pallas(a: torch.Tensor, b: torch.Tensor, *, bm: int = DEFAULT_BM,
                  bn: int = DEFAULT_BN, bk: int = DEFAULT_BK, splits: int = 1,
                  terms: int = 2) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n]; A f32, B bf16/fp16, C f32.

    Shapes must be multiples of the block sizes; ``ops.shgemm`` pads
    arbitrary shapes before calling this.  ``splits`` (port only) must
    divide ``k / bk``; with more than one, a workspace of
    ``workspace_bytes`` is allocated and the reduction kernel launched too.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"A must be f32, got {a.dtype}")
    if b.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"B must be bf16/fp16, got {b.dtype}")
    check_plan(m, n, k, bm, bn, bk, splits)
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
    w = (torch.empty((k // bk, m, n), dtype=torch.float32, device=a.device)
         if splits > 1 else None)
    err = _launcher()(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      None if w is None else w.data_ptr(), m, n, k, bm, bn, bk,
                      splits, terms, int(b.dtype == torch.float16),
                      torch.cuda.current_stream(a.device).cuda_stream,
                      a.device.index or 0)
    if err:
        raise RuntimeError(f"shgemm kernel launch failed: CUDA error {err}")
    global launches, reductions
    launches += 1
    reductions += splits > 1
    return c
