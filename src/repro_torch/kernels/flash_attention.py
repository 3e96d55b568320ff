"""Kernel 3: causal GQA flash attention (blockwise online softmax).

Port of the Pallas TPU kernel ``_flash_kernel``
(``repro/kernels/flash_attention.py``, entry ``flash_attention``) as
hand-written CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``): one
block per (q block, batch x kv head) carrying the G = H / KV query heads of
its group (four warps of 32 query rows, two blocks an SM; 16 * (8 // G)
positions of each head, so any G from 1 to 8, with 128 - G * bq zero rows
at G = 3, 5, 6, 7), the kv loop
inside the block and only up to the causal diagonal, Q and 32-key K/V tiles
copied into shared memory by ``cp.async`` (K/V through a two-tile ring),
bf16 fragments by ``ldmatrix`` (V's transposed on the way), the mask only on
diagonal and ragged-edge tiles, an ``exp2f`` softmax, m / l / the
accumulator in registers, both products on ``mma.sync`` with f32
accumulation.  bf16 inputs round P to bf16 for P.V; f32 inputs split every
operand into bf16 hi + lo (three products each), which keeps the result at
f32 accuracy.

q/k/v are read in their (B, S, heads, hd) layout by strides: the
reference's transposing copy to (B*KV, G, S, hd) is gone, and the ragged
edge (S not a multiple of the block) is masked inside the kernel, so no
caller pads.

``flash_attention`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``flash_attention_plain``) only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import shgemm as _k

# Query rows (all G heads of a group) per block, and its warps (32 rows
# each).
BLOCK_ROWS = 128
WARPS = 4
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
GROUPS = tuple(range(1, 9))
# Query chunk of the plain version: scores are (B, KV, G, chunk, S) f32.
PLAIN_CHUNK = 1024

# Kernel launches made by ``flash_attention`` in this process.
launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None,
                          chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores and softmax over
    query chunks (each against the keys up to its last row when causal), so
    the (S, S) matrix never exists whole."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    if scale is None:
        scale = hd ** -0.5
    kf = k.float().permute(0, 2, 1, 3)                 # (B, KV, S, hd)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty_like(q)
    for i in range(0, s, chunk):
        j = min(i + chunk, s)
        hi = j if causal else s
        qc = q[:, i:j].float().reshape(b, j - i, kv, g, hd)
        sc = torch.einsum("bqkgd,bksd->bkgqs", qc, kf[:, :, :hi]) * scale
        if causal:
            mask = (torch.arange(hi, device=q.device)[None, :]
                    <= torch.arange(i, j, device=q.device)[:, None])
            sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
        p = torch.softmax(sc, dim=-1)
        oc = torch.einsum("bkgqs,bksd->bqkgd", p, vf[:, :, :hi])
        out[:, i:j] = oc.reshape(b, j - i, h, hd).to(q.dtype)
    return out


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(hd: int, dtype=torch.bfloat16, device=None) -> int:
    """Blocks of the kernel for head size ``hd`` (64 or 128) and ``dtype``
    that one SM holds at once (the CUDA occupancy calculator on the built
    kernel); needs the card."""
    fn = _build.load("flash_attention").flash_attention_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(hd, int(dtype == torch.float32), torch.device(device or "cuda").index or 0)
    if n < 0:
        raise RuntimeError(f"no occupancy for the flash kernel at hd={hd}, {dtype}")
    return n


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         f"kv heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd) in q.dtype."""
    check_shapes(q, k, v)
    b, s, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or h // k.shape[2] not in GROUPS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS} and "
                         f"H/KV in {GROUPS}, got {hd} and {h // k.shape[2]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _k.check_launch_operand(x, name, q.device)
    # The kernel's softmax folds scale * log2(e) into one FMA and takes
    # scale > 0: q . k * s = (-q) . k * (-s), and at s = 0 every score is 0.
    if scale < 0:
        q, scale = -q, -scale
    elif scale == 0:
        q, scale = torch.zeros_like(q), 1.0
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, s, h, k.shape[2], hd, int(causal), float(scale),
                      int(q.dtype == torch.float32),
                      torch.cuda.current_stream(q.device).cuda_stream,
                      q.device.index or 0)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def causal_flops(b: int, s: int, h: int, hd: int) -> float:
    """Operations the causal attention needs: the two products over the
    s(s+1)/2 (query, key) pairs at or below the diagonal, 2 per MAC."""
    return 2.0 * 2.0 * b * h * hd * s * (s + 1) / 2.0
