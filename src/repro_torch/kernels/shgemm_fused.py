"""Kernel 2: fused RNG + SHGEMM, C_f32 = A_f32 @ Omega(key) with Omega
generated inside the kernel and never stored in device memory.

Port of the Pallas TPU kernel ``_fused_kernel``
(``repro/kernels/shgemm_fused.py``, entry ``shgemm_fused_pallas``) as
hand-written CUDA C++ for ``sm_90a`` (``csrc/shgemm_fused.cu`` over
``csrc/shgemm_splitk.cuh``): the split GEMM of kernel 1, with each (32, bn)
Omega stage hashed into shared memory from (key words, global row +
row_offset, global col + col_offset), once per block and shared by its
warps.  ``splits`` > 1 cuts K into that many runs of whole ``bk`` tiles,
one per block along the grid's third axis; each writes its tiles' partial
products to a workspace (``shgemm.workspace_bytes``) and a second kernel
sums them in tile order, so the output bits depend on ``bk`` alone, never on
the blocks or the split count, and equal kernel 1's on the same Omega.

Determinism contract (the reference's DESIGN.md §9): every Omega element is
a pure function of (key, row, col) on the global lattice.  The uint32 bits
are exact on any backend (uint32 arithmetic wraps; on the host it runs in
int64 masked to 32 bits, with each multiply split into 16-bit halves so no
intermediate passes 2^63), the sparse dists use only exact float ops, and
the Gaussian passes through log and cos, so its values agree only to a
tolerance across backends.

Host side (``counter_bits``, ``sample_tile``, ``reference_omega``) runs on
any device and is the kernel's plain version's Omega.  Keys are the
reference's (1, 2) uint32 key words, held as a pair of Python ints.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import shgemm as _k

SKETCH_DISTS = ("gaussian", "achlioptas", "very_sparse")

# murmur3 finalizer constants + golden-ratio lane salts.
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_ROW_SALT = 0x9E3779B9
_COL_SALT = 0x7F4A7C15
_STREAM_SALT = 0x632BE59B
_MASK = 0xFFFFFFFF

_TWO_NEG_24 = float(2.0**-24)
_TWO_NEG_25 = float(2.0**-25)

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
_STORE_KIND = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}


# Kernel launches made by ``shgemm_fused_pallas`` in this process, and how
# many of them also launched the split-K reduction.
launches = 0
reductions = 0


def key_pair(key) -> tuple[int, int]:
    """(k0, k1) from key words: a pair of ints, a (2,) or (1, 2) array or
    tensor (the reference's ``key_words`` output)."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().reshape(-1).tolist()
    elif isinstance(key, np.ndarray):
        key = key.reshape(-1).tolist()
    k0, k1 = (int(w) for w in key)
    return k0 & _MASK, k1 & _MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): the constant is split
    into 16-bit halves so every intermediate stays below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 words held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def counter_bits(k0: int, k1: int, rows: torch.Tensor, cols: torch.Tensor,
                 stream: int) -> torch.Tensor:
    """Avalanched uint32 (in int64) for each (row, col) lattice point of
    draw ``stream``; ``rows``/``cols`` are broadcast-compatible int64 index
    tensors, taken modulo 2^32 like the reference's int32 -> uint32 cast."""
    hr = _fmix32((_mul32(rows & _MASK, _ROW_SALT) + k0) & _MASK)
    salt = (stream * _STREAM_SALT + k1) & _MASK
    hc = _fmix32((_mul32(cols & _MASK, _COL_SALT) + salt) & _MASK)
    return _fmix32(hr ^ _mul32(hc, _M1))


def _uniform24(bits: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """Top 24 bits -> f32 uniform on [0,1) (+offset shifts off exact zero)."""
    return (bits >> 8).to(torch.float32) * _TWO_NEG_24 + offset


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 constant, so products and comparisons happen in f32 like
    the reference's weakly typed Python scalars."""
    return torch.tensor(np.float32(x), dtype=torch.float32, device=like.device)


def sample_tile(k0: int, k1: int, rows: torch.Tensor, cols: torch.Tensor, *,
                dist: str, s: float) -> torch.Tensor:
    """f32 samples (pre-rounding) for the global index tiles rows x cols."""
    if dist == "gaussian":
        u1 = _uniform24(counter_bits(k0, k1, rows, cols, 0), _TWO_NEG_25)
        u2 = _uniform24(counter_bits(k0, k1, rows, cols, 1))
        r = torch.sqrt(-2.0 * torch.log(u1))
        return r * torch.cos(_f32(2.0 * math.pi, u2) * u2)
    if dist in ("achlioptas", "very_sparse"):
        u = _uniform24(counter_bits(k0, k1, rows, cols, 0))
        return torch.where(u < _f32(1.0 / (2.0 * s), u), -1.0,
                           torch.where(u < _f32(1.0 / s, u), 1.0, 0.0))
    raise ValueError(f"unknown sketch distribution {dist!r}")


def _resolve_s(dist: str, s: float | None, k: int) -> float:
    """Sparsity parameter for the sign dists: an explicit ``s`` wins;
    otherwise Achlioptas s=3 and very_sparse s = sqrt(k) with k Omega's
    (global) row count, in f64 ``math.sqrt`` as the reference does."""
    if s is not None:
        return float(s)
    if dist == "very_sparse":
        return float(math.sqrt(k))
    return 3.0


def reference_omega(words, shape: tuple[int, int], *, dist: str = "gaussian",
                    s: float | None = None, dtype=torch.float32,
                    row_offset: int = 0, col_offset: int = 0,
                    device=None) -> torch.Tensor:
    """Materialize the exact Omega the fused kernel consumes.

    ``row_offset``/``col_offset`` shift the global lattice: the result is
    ``reference_omega(words, big)[r0:, c0:]`` restricted to ``shape``.
    """
    dev = resolve_device(device)
    k0, k1 = key_pair(words)
    k, n = shape
    rows = torch.arange(k, dtype=torch.int64, device=dev)[:, None] + int(row_offset)
    cols = torch.arange(n, dtype=torch.int64, device=dev)[None, :] + int(col_offset)
    vals = sample_tile(k0, k1, rows, cols, dist=dist, s=_resolve_s(dist, s, k))
    return vals.to(dtype)


def shgemm_fused_plain(a: torch.Tensor, words, n: int, *, terms: int = 2,
                       dist: str = "gaussian", s: float = 3.0,
                       store_dtype=None, lowp_dtype=torch.bfloat16,
                       row_offset: int = 0, col_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``shgemm_plain`` on the
    materialized Omega, rounded through ``store_dtype`` then ``lowp_dtype``."""
    omega = reference_omega(words, (a.shape[1], n), dist=dist, s=s,
                            dtype=store_dtype or lowp_dtype,
                            row_offset=row_offset, col_offset=col_offset,
                            device=a.device)
    return _k.shgemm_plain(a, omega.to(lowp_dtype), terms)


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of one block of kernel 2: kernel 1's
    (``shgemm.smem_bytes``) and ``GenOmega``'s table of the block's column
    hashes, two streams of bn words."""
    return _k.smem_bytes(bm, bn) + 2 * bn * 4


def _launcher():
    fn = _build.load("shgemm_fused").shgemm_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_uint32] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def shgemm_fused_pallas(a: torch.Tensor, words, n: int, *, bm: int, bn: int,
                        bk: int, splits: int = 1, terms: int = 2,
                        dist: str = "gaussian",
                        s: float = 3.0, store_dtype=None,
                        lowp_dtype=torch.bfloat16,
                        offsets: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """C[m, n] = A[m, k] @ Omega(words)[k+r0, n+c0]; Omega never touches
    device memory.  Shapes must be multiples of the block sizes;
    ``ops.shgemm_fused`` pads arbitrary shapes before calling this.
    ``splits`` must divide ``k / bk``; with more than one, a workspace of
    ``shgemm.workspace_bytes`` is allocated and the reduction kernel
    launched too.  ``offsets`` is ``(row_offset, col_offset)``."""
    m, k = a.shape
    if a.dtype != torch.float32:
        raise TypeError(f"A must be f32, got {a.dtype}")
    if lowp_dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"Omega dtype must be bf16/fp16, got {lowp_dtype}")
    _k.check_plan(m, n, k, bm, bn, bk, splits)
    if terms not in (1, 2, 3) or (terms == 3 and lowp_dtype == torch.float16):
        raise ValueError(f"terms={terms} unsupported for {lowp_dtype}")
    if dist not in SKETCH_DISTS:
        raise ValueError(f"unknown sketch distribution {dist!r}")
    store_dtype = store_dtype or lowp_dtype
    if store_dtype != lowp_dtype and (store_dtype not in _FP8
                                      or lowp_dtype != torch.bfloat16):
        raise TypeError(f"store_dtype {store_dtype} must be lowp_dtype or an "
                        f"fp8 format consumed as bf16")
    row_offset, col_offset = (int(o) for o in offsets)
    k0, k1 = key_pair(words)
    if a.device.type == "cpu":
        return shgemm_fused_plain(a, (k0, k1), n, terms=terms, dist=dist, s=s,
                                  store_dtype=store_dtype,
                                  lowp_dtype=lowp_dtype,
                                  row_offset=row_offset, col_offset=col_offset)
    if a.device.type != "cuda":
        raise ValueError(f"shgemm_fused_pallas runs on CUDA or CPU tensors, "
                         f"got {a.device}")
    _k.check_launch_operand(a, "A", a.device)
    if m // bm > 65535:
        raise ValueError(f"m={m} needs more than 65535 row blocks of {bm}")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    w = (torch.empty((k // bk, m, n), dtype=torch.float32, device=a.device)
         if splits > 1 else None)
    err = _launcher()(
        a.data_ptr(), c.data_ptr(), None if w is None else w.data_ptr(), m, n,
        k, k0, k1, row_offset & _MASK, col_offset & _MASK, bm, bn, bk, splits,
        terms,
        int(lowp_dtype == torch.float16), _STORE_KIND.get(store_dtype, 0),
        0 if dist == "gaussian" else 1,
        float(np.float32(1.0 / (2.0 * s))), float(np.float32(1.0 / s)),
        torch.cuda.current_stream(a.device).cuda_stream, a.device.index or 0)
    if err:
        raise RuntimeError(f"shgemm_fused kernel launch failed: CUDA error {err}")
    global launches, reductions
    launches += 1
    reductions += splits > 1
    return c


def hbm_bytes_modeled(m: int, n: int, k: int, *, fused: bool,
                      b_dtype=torch.bfloat16) -> int:
    """Modeled device-memory traffic of one projection: A reads + C writes,
    plus Omega reads only on the materialized path."""
    traffic = m * k * 4 + m * n * 4
    if not fused:
        traffic += k * n * b_dtype.itemsize
    return traffic
