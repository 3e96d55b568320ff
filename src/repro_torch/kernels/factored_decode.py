"""Kernel 4: single-token decode attention over a factored KV prefix and a
dense tail.

Port of the Pallas TPU kernel ``_fdec_kernel``
(``repro/kernels/factored_decode.py``, entry ``factored_decode_attention``)
as hand-written CUDA C++ for ``sm_90a`` (``csrc/factored_decode.cu``): a
split-KV layout (one block per live kv block and (slot, kv head), then a
merge of the partial softmax states), reading the cache (B, S, KV, hd) and
the factors (B, KV, S, r) in place by strides.  The skip rules of the TPU
kernel hold: blocks past ``write_pos`` are not launched, prefix rows read no
dense row, tail rows no factor, and a slot with ``comp_len == 0`` never
reads its factors.

The plain version is ``models.layers.factored_decode_attention`` (the
reference's jnp oracle, ported).  ``factored_decode_attention`` launches the
kernel for CUDA tensors and runs the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import shgemm as _k
from repro_torch.models.layers import factored_decode_attention as _oracle

# Dynamic shared memory of a block, (G * (hd + r + block_kv)) floats, stays
# under the 48 KB a launch may take without opting in.
SMEM_LIMIT = 48 * 1024
# q/out and the cache may differ: a bf16 cache under f32 activations.
_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches made by ``factored_decode_attention`` in this process.
launches = 0


def _round_up(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


def heuristic_decode_block(s: int) -> int:
    """Shrink-to-fit kv block for a decode shape (the port's copy of
    ``repro/kernels/autotune.py:heuristic_decode_block``): one 256-wide
    block per kv chunk, or a single block covering short caches."""
    if s >= 256:
        return 256
    return max(8, _round_up(s, 8))


def factored_decode_plain(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                          write_pos: int, *, scale: float,
                          cap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the model's oracle."""
    return _oracle(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                   write_pos=write_pos, scale=scale, cap=cap)


def _launcher():
    fn = _build.load("factored_decode").factored_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def factored_decode_attention(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                              write_pos: int, *, scale: float,
                              cap: float = 0.0,
                              block_kv: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v: (B, S, KV, hd); k_us/v_us: (B, KV, S, r);
    k_vt/v_vt: (B, KV, r, hd); comp_len: (B,) int; write_pos: int (the
    decode clock).  Returns (B, 1, H, hd) in q.dtype."""
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"decode kernel is single-token; got S_q={sq}")
    skv, kvh = k.shape[1], k.shape[2]
    r = k_us.shape[-1]
    write_pos = int(write_pos)
    if not 0 <= write_pos < skv:
        raise ValueError(f"write_pos={write_pos} outside the cache of {skv} rows")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if block_kv is None:
        block_kv = heuristic_decode_block(skv)
    if q.device.type == "cpu":
        return factored_decode_plain(q, k, v, k_us, k_vt, v_us, v_vt,
                                     comp_len, write_pos, scale=scale, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"factored_decode_attention runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"fdec kernel takes bf16 or f32 q and bf16 or f32 k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    g = h // kvh
    if 4 * g * (hd + r + block_kv) > SMEM_LIMIT:
        raise ValueError(f"block_kv={block_kv} needs more than {SMEM_LIMIT} "
                         f"bytes of shared memory at G={g}, hd={hd}, r={r}")
    factors = (k_us, k_vt, v_us, v_vt)
    if any(f.dtype != torch.float32 for f in factors):
        raise TypeError("factors must be f32")
    if k_us.shape != (b, kvh, skv, r) or v_us.shape != k_us.shape \
            or k_vt.shape != (b, kvh, r, hd) or v_vt.shape != k_vt.shape:
        raise ValueError("factor shapes do not match the cache")
    comp = comp_len.to(device=q.device, dtype=torch.int32)
    for name, x in (("q", q), ("k", k), ("v", v), ("k_us", k_us),
                    ("k_vt", k_vt), ("v_us", v_us), ("v_vt", v_vt),
                    ("comp_len", comp)):
        _k.check_launch_operand(x, name, q.device)
    out = torch.empty_like(q)
    nblk = write_pos // block_kv + 1        # only blocks up to the clock run
    ws = torch.empty(b * kvh * nblk * g * (2 + hd + r), dtype=torch.float32,
                     device=q.device)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      k_us.data_ptr(), k_vt.data_ptr(), v_us.data_ptr(),
                      v_vt.data_ptr(), comp.data_ptr(), out.data_ptr(),
                      ws.data_ptr(), b, skv, h, kvh, hd, r, write_pos,
                      block_kv, float(scale), float(cap),
                      int(q.dtype == torch.float32),
                      int(k.dtype == torch.float32),
                      torch.cuda.current_stream(q.device).cuda_stream,
                      q.device.index or 0)
    if err:
        raise RuntimeError(f"factored_decode kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def bytes_needed(q, k, k_us, comp_len, write_pos: int) -> int:
    """Bytes the function must move for these inputs: q and the output once,
    each live dense row of k and v, each live factored row of us_k and us_v,
    and vt_k / vt_v for compressed slots (what this data needs, not the
    whole cache)."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    r = k_us.shape[-1]
    live = int(write_pos) + 1
    comp = [min(int(c), live) for c in comp_len.tolist()]
    dense_rows = sum(live - c for c in comp)
    fact_rows = sum(comp)
    n_comp = sum(1 for c in comp if c > 0)
    return (2 * b * h * hd * q.element_size()
            + 2 * dense_rows * kvh * hd * k.element_size()
            + 2 * fact_rows * kvh * r * 4
            + 2 * n_comp * kvh * r * hd * 4)


def operations_needed(q, k, k_us, comp_len, write_pos: int) -> int:
    """Multiply-adds x 2 the function needs for these inputs: dense rows
    2·hd per head for scores and values, factored rows 2·r, plus
    q·vt_k^T and acc_f·vt_v (r·hd each) per head of a compressed slot."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    r = k_us.shape[-1]
    live = int(write_pos) + 1
    comp = [min(int(c), live) for c in comp_len.tolist()]
    ops = 0
    for c in comp:
        ops += kvh * g * ((live - c) * 2 * hd + c * 2 * r)
        if c:
            ops += kvh * g * 2 * r * hd
    return 2 * ops
