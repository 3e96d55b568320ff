"""Public wrappers around the hand-written kernels (port of
``repro/kernels/ops.py``).

``shgemm(a, b)`` takes arbitrary shapes: it pads to block multiples, runs
kernel 1 (``kernels/shgemm.py``) and slices the padding off.
``shgemm_fused(a, key, n)`` is the zero-device-memory-Omega variant
(``kernels/shgemm_fused.py``).  ``flash_attention`` (kernel 3) and
``factored_decode_attention`` (kernel 4) are the attention entries the model
calls under ``cfg.use_flash_kernel``; both kernels mask their ragged edges
themselves, so nothing here pads them.  Both run on the card unless the caller
passes ``device="cpu"``, where the kernels' plain versions run.

Kernel 1's blocks and split-K count come from ``shgemm_plan`` and kernel
2's from ``fused_plan``, unless ``blocks=`` / ``splits=`` are given; both
kernels run one main loop, so both planners share the tiles, ``bk`` and
the split count's rule (``plan_splits``).  Without ``blocks=`` and
``splits=``, ``shgemm`` and ``shgemm_fused`` first consult the autotuner
(``kernels/autotune.py``: a plan tuned for this shape on this card, at the
planner's ``bk``, so the same bits); without ``block_kv=`` and ``splits=``,
``factored_decode_attention`` takes kernel 4's P from it.  A miss serves the
planner's plan.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import autotune
from repro_torch.kernels import factored_decode as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import shgemm as _k
from repro_torch.kernels import shgemm_fused as _kf

# Streaming multiprocessors of an H100 SXM.
SM_COUNT = 132


def _round_up(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


# The split count: the least share of the waves its grid occupies that the
# blocks must fill, and the most workspace a split may take.
WAVE_FILL = 0.8
MAX_WORKSPACE_BYTES = 1 << 30

# Blocks of kernel 1's 128 x 32 tile, the tile its planner gives every m
# over 64, that one H100 SM holds at once, by term count: shared memory
# allows three (66 KB each), and three terms take the registers of only
# two (``shgemm.blocks_per_sm``, the CUDA occupancy calculator; chip_smoke.py
# checks these).  The smaller tiles of m <= 64 fit more, so there the split
# count may be more than the card needs.
SHGEMM_PER_SM = {1: 3, 2: 3, 3: 2}


def plan_splits(m: int, n: int, k: int, blocks: tuple[int, int, int],
                per_sm: int = 1) -> int:
    """The split-K count of kernels 1 and 2 for ``blocks``, of which an SM
    holds ``per_sm`` at once: the smallest divisor of the ``k / bk`` tiles
    whose grid has at least ``SM_COUNT`` blocks and either fits on the card
    at once or fills at least ``WAVE_FILL`` of the waves it occupies (so no
    nearly empty last wave doubles the time), or the largest divisor where
    none does; 1 where the workspace would pass ``MAX_WORKSPACE_BYTES``."""
    bm, bn, bk = blocks
    tiles = -(-k // bk)
    grid = -(-m // bm) * -(-n // bn)
    slots = SM_COUNT * per_sm
    if _k.workspace_bytes(_round_up(m, bm), _round_up(n, bn), tiles * bk, bk,
                          2) > MAX_WORKSPACE_BYTES:
        return 1

    def fills(d: int) -> bool:
        nb = grid * d
        return nb >= SM_COUNT and (
            nb <= slots or nb >= WAVE_FILL * slots * -(-nb // slots))

    divisors = [d for d in range(1, min(tiles, _k.MAX_SPLITS) + 1)
                if tiles % d == 0]
    return next((d for d in divisors if fills(d)), divisors[-1])


def _plan_blocks(m: int, n: int, k: int,
                 max_bm: int = 256) -> tuple[int, int, int]:
    """(bm, bn, bk) of both planners.  bm is the smallest row block that
    covers m, up to ``max_bm``; bn is the column block of that tile with
    the least padding of n (the larger on a tie); bk is the reference's
    256, or k rounded up to the 32-deep stage where that is less."""
    bm = next((b for b in (32, 64, 128, 256) if b >= m or b == max_bm))
    bn = min((b for b in (32, 64) if (bm, b) in _k.TILES),
             key=lambda b: (_round_up(n, b), -b))
    bk = min(_k.DEFAULT_BK, _round_up(max(k, 1), _k.STAGE_K))
    return bm, bn, bk


def shgemm_plan(m: int, n: int, k: int,
                terms: int = 2) -> tuple[int, int, int, int]:
    """Kernel 1's (bm, bn, bk, splits).  Rows up to 128 a block: kernel 1
    hashes nothing, so sharing a B stage among eight warps (256 rows) buys
    less than the occupancy it costs -- three 128 x 32 blocks (12 warps) fit
    an SM, one 256 x 32 block (8 warps).  On an NVIDIA H100 80GB HBM3
    (700 W) 128 x 32 took 0.172-0.174 ms of device time at rSVD against
    0.264-0.373 for 256 x 32 under any split count, and 0.044 ms at
    RP-HOSVD against 0.049-0.051 (chip_smoke.py's ``[plans] kernel 1``
    lines).  bk equals ``fused_plan``'s, so kernels 1 and 2 give the same
    bits; the split count is ``plan_splits``' with ``SHGEMM_PER_SM``."""
    blocks = _plan_blocks(m, n, k, max_bm=128)
    return (*blocks, plan_splits(m, n, k, blocks, SHGEMM_PER_SM[terms]))


def fused_plan(m: int, n: int, k: int) -> tuple[int, int, int, int]:
    """Kernel 2's (bm, bn, bk, splits).  Rows up to 256 a block: there the
    eight warps of a block share each Omega stage, so Omega is hashed once
    for every 256 rows of A, and one block fills an SM; the split count is
    ``plan_splits``'."""
    blocks = _plan_blocks(m, n, k)
    return (*blocks, plan_splits(m, n, k, blocks))


def _pad_to(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x.contiguous()


def shgemm(a, b, *, blocks: tuple[int, int, int] | None = None,
           splits: int | None = None, terms: int = 2,
           device=None) -> torch.Tensor:
    """C_f32 = A_f32 @ B_lowp for arbitrary shapes.

    B may be bf16 or fp16; any other B is cast to bf16.  A is cast to f32.
    ``blocks`` is the reference's ``(bm, bn, bk)``; without it the blocks
    come from ``shgemm_plan``.  ``splits`` (port only) pins the split-K
    count, which must divide the padded k's ``bk`` tiles; without it
    ``plan_splits`` picks it for the blocks.  Without both, the plan is the
    autotuner's (``autotune.pick_blocks``: tuned, else ``shgemm_plan``).
    The result's bits depend on ``bk`` alone.
    """
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    b = on_device(b, dev)
    if b.dtype not in (torch.bfloat16, torch.float16):
        b = b.to(torch.bfloat16)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if terms not in SHGEMM_PER_SM:
        raise ValueError(f"terms={terms} unsupported")
    if blocks is None and splits is None:
        bm, bn, bk, planned = autotune.pick_blocks(
            m, n, k, b_dtype=b.dtype, terms=terms, device=dev)
    elif blocks is None:
        bm, bn, bk, planned = shgemm_plan(m, n, k, terms)
    else:
        bm, bn, bk = blocks
        _k.check_blocks(bm, bn, bk)
        planned = plan_splits(m, n, k, blocks, SHGEMM_PER_SM[terms])
    c = _k.shgemm_pallas(_pad_to(a, bm, bk), _pad_to(b, bk, bn), bm=bm, bn=bn,
                         bk=bk, splits=planned if splits is None else splits,
                         terms=terms)
    return c[:m, :n]


def shgemm_nt(a, b_t, **kw) -> torch.Tensor:
    """C = A @ B_t^T (B stored transposed, e.g. row-major random matrices)."""
    return shgemm(a, b_t.T, **kw)


def _validate_offset(name: str, value, unit: int) -> None:
    """Block-alignment check for offsets (clear error, per the streaming
    contract of the reference's DESIGN.md §10)."""
    if isinstance(value, (int, np.integer)):
        if value < 0:
            raise ValueError(f"{name}={value} must be >= 0")
        if value % unit:
            raise ValueError(
                f"{name}={value} is not a multiple of the {unit}-wide kernel "
                f"block on that axis; streamed tiles must be block-aligned "
                f"with the one-shot lattice (pass blocks=... explicitly to "
                f"pick a compatible tiling, or align the offset)")


def shgemm_fused(a, key, n: int, *, dist: str = "gaussian",
                 omega_dtype=torch.bfloat16,
                 blocks: tuple[int, int, int] | None = None, terms: int = 2,
                 s: float | None = None, row_offset: int = 0,
                 col_offset: int = 0, splits: int | None = None,
                 device=None) -> torch.Tensor:
    """C_f32 = A_f32 @ Omega(key)[row_offset:+k, col_offset:+n], Omega
    generated in-kernel.

    ``blocks`` is the reference's ``(bm, bn, bk)``; without it the blocks
    come from ``fused_plan``.  ``splits`` (port only) pins the split-K count,
    which must divide the padded k's ``bk`` tiles; without it
    ``plan_splits`` picks it for the blocks.  Without both, the plan is the
    autotuner's (``autotune.pick_blocks(fused=True)``: tuned, else
    ``fused_plan``).  The result's bits depend on ``bk`` alone.

    A is zero-padded to block multiples: pad rows of A null the extra
    generated Omega rows and pad columns are sliced off, so the result does
    not depend on the padding.  An fp8 ``omega_dtype`` is storage only: the
    samples round through fp8 and are consumed as bf16.  ``row_offset``
    must be a multiple of the resolved ``bk``; ``col_offset`` any value
    >= 0.  For ``dist="very_sparse"`` on a partial row block, pass the
    global data dimension's ``s``: the default comes from this call's k.
    """
    if dist in ("srht", "khatri_rao"):
        raise ValueError(
            f"dist={dist!r} is a structured family with no GEMM to fuse — "
            f"use core.projection.sketch (SRHT O(n log n) apply path) or "
            f"core.structured.KhatriRaoOmega instead of the fused kernel")
    dev = resolve_device(device)
    a = on_device(a, dev).to(torch.float32)
    m, k = a.shape
    if omega_dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        compute_dtype = torch.bfloat16  # e8m7 superset of both fp8 formats
    elif omega_dtype in (torch.bfloat16, torch.float16):
        compute_dtype = omega_dtype
    else:
        raise TypeError(f"omega_dtype must be bf16/fp16/fp8, got {omega_dtype}")
    if blocks is None and splits is None:
        bm, bn, bk, planned = autotune.pick_blocks(
            m, n, k, b_dtype=omega_dtype, terms=terms, fused=True, device=dev)
    elif blocks is None:
        bm, bn, bk, planned = fused_plan(m, n, k)
    else:
        bm, bn, bk = blocks
        _k.check_blocks(bm, bn, bk)
        planned = plan_splits(m, n, k, blocks)
    _validate_offset("row_offset", row_offset, bk)
    _validate_offset("col_offset", col_offset, 1)
    n_pad = n + (-n) % bn
    c = _kf.shgemm_fused_pallas(
        _pad_to(a, bm, bk), key, n_pad, bm=bm, bn=bn, bk=bk,
        splits=planned if splits is None else splits, terms=terms, dist=dist,
        s=_kf._resolve_s(dist, s, k), store_dtype=omega_dtype,
        lowp_dtype=compute_dtype, offsets=(row_offset, col_offset))
    return c[:m, :n]


def chip_omega(key, k: int, n: int, *, dist: str = "gaussian",
               omega_dtype=torch.bfloat16, s: float | None = None,
               row_offset: int = 0, col_offset: int = 0, chunk: int = 4096,
               device=None) -> torch.Tensor:
    """Kernel 2's own Omega[row_offset:+k, col_offset:+n] in the 16-bit type
    its MMAs consume, read back through the kernel with A = I, ``chunk``
    rows at a time: with A = I every split term, product and partial sum is
    exact, so the output is the generated Omega.  ``s`` defaults to the one
    of a k-row Omega, as ``shgemm_fused``'s does."""
    dev = resolve_device(device)
    s = _kf._resolve_s(dist, s, k)
    lowp = torch.bfloat16 if omega_dtype in _kf._FP8 else omega_dtype
    parts = []
    for r in range(0, k, chunk):
        rows = min(chunk, k - r)
        parts.append(shgemm_fused(
            torch.eye(rows, device=dev), key, n, dist=dist,
            omega_dtype=omega_dtype, s=s, row_offset=row_offset + r,
            col_offset=col_offset, device=dev).to(lowp))
    return torch.cat(parts)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Causal (or full) GQA attention through kernel 3; q (B, S, H, hd),
    k/v (B, S, KV, hd), any S.  The reference pads S to its block and sends
    ragged non-causal shapes to the oracle; this kernel masks the ragged
    edge itself, so neither is needed."""
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale)


def factored_decode_attention(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                              write_pos: int, *, scale: float,
                              cap: float = 0.0,
                              block_kv: int | None = None,
                              splits: int | None = None) -> torch.Tensor:
    """Factored-prefix decode attention through kernel 4, same signature and
    semantics as the oracle ``models.layers.factored_decode_attention``;
    ``write_pos`` may be an int32 tensor on the card.  ``block_kv`` is the
    grain of the kernel's split boundaries (``factored_decode.GRAIN`` unless
    given); the split count P is ``splits``, else ``decode_plan``'s for that
    grain.  Without both, P is the autotuner's
    (``autotune.pick_decode_block``: tuned for these shapes on this card,
    else ``decode_plan``'s), resolved once per shape."""
    if splits is None and block_kv is None:
        b, _, h, hd = q.shape
        kvh = k.shape[2]
        splits = autotune.pick_decode_block(
            b, kvh, k.shape[1], h // kvh, hd, k_us.shape[-1],
            kv_bytes=k.element_size(), device=q.device)
    return _fd.factored_decode_attention(
        q, k, v, k_us, k_vt, v_us, v_vt, comp_len, write_pos, scale=scale,
        cap=cap, block_kv=block_kv, splits=splits)
