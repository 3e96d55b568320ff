"""Kernel 4: single-token decode attention over a factored KV prefix and a
dense tail.

Port of the Pallas TPU kernel ``_fdec_kernel``
(``repro/kernels/factored_decode.py``, entry ``factored_decode_attention``)
as hand-written CUDA C++ for ``sm_90a`` (``csrc/factored_decode.cu``): one
launch of (P, B·KV) blocks, P from ``decode_plan`` (shapes alone, never the
decode clock).  Each block reads ``write_pos`` and its slot's ``comp_len``
on the device and takes an equal share of the live rows ``[0, write_pos]``
on a ``grain``-row boundary (``split_bounds``), which it streams through
shared memory a chunk at a time under one online softmax; the last block of
each (slot, kv head) to finish merges the P partial softmax states in split
order, so the result does not depend on block timing.  The cache (B, S, KV,
hd) and the factors (B, KV, S, r) are read in place by strides.  The skip
rules of the TPU kernel hold: rows past ``write_pos`` are not read, prefix
rows read no dense row, tail rows no factor, and a slot with
``comp_len == 0`` never reads its factors.

``write_pos`` is an int or a one-element int32 tensor on the card (the
reference traces it); the kernel reads the tensor on the device, so the
launch reads nothing back to the host and is the same at every step: it can
be captured in a CUDA graph and replayed at any clock.

The plain version is ``models.layers.factored_decode_attention`` (the
reference's jnp oracle, ported).  ``factored_decode_attention`` launches the
kernel for CUDA tensors and runs the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import shgemm as _k
from repro_torch.models.layers import factored_decode_attention as _oracle

# Split boundaries are multiples of GRAIN rows unless the caller gives
# ``block_kv``.
GRAIN = 8
THREADS = 128
# Blocks an SM the planner fills the card with: four of the bf16 engine
# shape's 57 KB blocks fit an SM's shared memory.
BLOCKS_PER_SM = 4
# The kernel's ring of NSTAGE chunks, each at most STAGE_BYTES of K and V
# rows (``csrc/factored_decode.cu``).
NSTAGE = 3
STAGE_BYTES = 16384
# Dynamic shared memory a block may take on an H100 (opted in above 48 KB).
SMEM_LIMIT = 227 * 1024
# q/out and the cache may differ: a bf16 cache under f32 activations.
_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches made by ``factored_decode_attention`` in this process.
launches = 0


class DecodePlan(NamedTuple):
    splits: int      # P: blocks per (slot, kv head)
    grain: int       # rows; split boundaries are multiples of it
    smem: int        # dynamic shared memory of a block, bytes
    workspace: int   # f32 words of the partials: B·KV·P·G·(2 + hd + r)


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _pad4(x: int) -> int:
    return _cdiv(x, 4) * 4


def chunk_rows(hd: int, r: int, kv_bytes: int) -> tuple[int, int, int, int]:
    """(tail rows a chunk, bytes between staged cache rows, prefix rows a
    chunk, bytes between staged factor rows): rows padded to 16 bytes, a
    chunk's K and V rows fill at most STAGE_BYTES, 8 to 64 rows."""
    rs, rsf = _cdiv(kv_bytes * hd, 16) * 16, _cdiv(4 * r, 16) * 16
    return (min(64, max(8, STAGE_BYTES // (2 * rs) // 8 * 8)), rs,
            min(64, max(8, STAGE_BYTES // (2 * rsf) // 8 * 8)), rsf)


def smem_bytes(g: int, hd: int, r: int, splits: int, kv_bytes: int) -> int:
    """Dynamic shared memory of a block (``layout`` in the kernel's source):
    q (G, hd), q·vt_k^T (G, r), a chunk's scores (G, max chunk rows),
    m/l/alpha/m after the prefix (4, G), the two value accumulators by
    (head, vector, row subset), and the ring of NSTAGE chunks, which the
    merge's m_k / weights and l_k (2, G, P) and merged acc_f (G, r) reuse;
    each region but the last padded to 16 bytes."""
    ch, rs, chf, rsf = chunk_rows(hd, r, kv_bytes)
    vd = 16 // kv_bytes if hd % (16 // kv_bytes) == 0 else 1
    vf = 4 if r % 4 == 0 else 1

    def acc(pairs, v):
        return _pad4(pairs * (1 if pairs >= THREADS else THREADS // pairs) * v)
    ring = NSTAGE * 2 * max(ch * rs, chf * rsf) // 4
    words = (_pad4(g * hd) + _pad4(g * r) + _pad4(g * max(ch, chf)) + _pad4(4 * g)
             + acc(g * (hd // vd), vd) + acc(g * (r // vf), vf)
             + max(ring, _pad4(2 * g * splits) + g * r))
    return 4 * words


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, kvh: int, s: int, hd: int, r: int, g: int, *,
                sms: int = 132, kv_bytes: int = 2, grain: int = GRAIN,
                splits: int | None = None) -> DecodePlan:
    """The launch of kernel 4 for these shapes (``kv_bytes``: the cache's
    element size); no ``write_pos`` enters, so the grid and the workspace
    stay the same at every decode step.  P puts ``BLOCKS_PER_SM`` blocks an
    SM over the B·KV rows in one wave, at most one split a grain of the
    cache.  ``splits`` pins P."""
    if min(b, kvh, s, hd, r, g, grain) <= 0:
        raise ValueError(f"decode_plan needs positive shapes, got b={b} "
                         f"kvh={kvh} s={s} hd={hd} r={r} g={g} grain={grain}")
    p = splits if splits is not None else max(1, min(
        _cdiv(s, grain), BLOCKS_PER_SM * sms // (b * kvh)))
    if p <= 0:
        raise ValueError(f"splits={p} must be positive")
    smem = smem_bytes(g, hd, r, p, kv_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{p} splits need {smem} bytes of shared memory "
                         f"(limit {SMEM_LIMIT}) at G={g}, hd={hd}, r={r}")
    return DecodePlan(p, grain, smem, b * kvh * p * g * (2 + hd + r))


def split_bounds(plan: DecodePlan, write_pos: int) -> list[tuple[int, int]]:
    """Rows [start, end) of each split at this clock, as each block of the
    kernel computes them: the live rows [0, write_pos] in equal shares of
    whole grains, empty shares (start == end) at the back."""
    live = int(write_pos) + 1
    per = _cdiv(_cdiv(live, plan.grain), plan.splits) * plan.grain
    return [(min(k * per, live), min(k * per + per, live))
            for k in range(plan.splits)]


def factored_decode_plain(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                          write_pos, *, scale: float,
                          cap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the model's oracle."""
    return _oracle(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                   write_pos=int(write_pos), scale=scale, cap=cap)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("factored_decode").factored_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


# Per (device, stream): the merge's tickets (int32 zeros, one a (slot, kv
# head); the kernel's last block of each row resets its ticket, so they are
# zero between launches) and the partials' workspace (f32).  Launches on one
# stream run in turn and share both; their addresses stay put from call to
# call.
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_buffers(device: int, stream: int, tickets: int,
                     words: int) -> tuple[torch.Tensor, torch.Tensor]:
    bufs = _scratch.get((device, stream))
    if bufs is None or bufs[0].numel() < tickets or bufs[1].numel() < words:
        dev = torch.device("cuda", device)
        old = bufs or (torch.empty(0), torch.empty(0))
        bufs = _scratch[(device, stream)] = (
            torch.zeros(max(tickets, old[0].numel()), dtype=torch.int32, device=dev),
            torch.empty(max(words, old[1].numel()), dtype=torch.float32, device=dev))
    return bufs


def factored_decode_attention(q, k, v, k_us, k_vt, v_us, v_vt, comp_len,
                              write_pos, *, scale: float, cap: float = 0.0,
                              block_kv: int | None = None,
                              splits: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v: (B, S, KV, hd); k_us/v_us: (B, KV, S, r);
    k_vt/v_vt: (B, KV, r, hd); comp_len: (B,) int; write_pos: the decode
    clock, an int or a one-element int tensor (for CUDA tensors an int32
    tensor on their device, read by the kernel: its range is the caller's
    contract, and a clock outside [0, S) gives NaN).  ``block_kv`` is the
    grain of the split boundaries (``GRAIN`` by default) and ``splits`` pins
    P (``decode_plan`` by default); neither changes what is computed.
    Returns (B, 1, H, hd) in q.dtype."""
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"decode kernel is single-token; got S_q={sq}")
    skv, kvh = k.shape[1], k.shape[2]
    r = k_us.shape[-1]
    on_card = (isinstance(write_pos, torch.Tensor)
               and write_pos.device.type == "cuda")
    if not on_card:
        write_pos = int(write_pos)
        if not 0 <= write_pos < skv:
            raise ValueError(f"write_pos={write_pos} outside the cache of "
                             f"{skv} rows")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if q.device.type == "cpu":
        return factored_decode_plain(q, k, v, k_us, k_vt, v_us, v_vt,
                                     comp_len, write_pos, scale=scale, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"factored_decode_attention runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"fdec kernel takes bf16 or f32 q and bf16 or f32 k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    factors = (k_us, k_vt, v_us, v_vt)
    if any(f.dtype != torch.float32 for f in factors):
        raise TypeError("factors must be f32")
    if k_us.shape != (b, kvh, skv, r) or v_us.shape != k_us.shape \
            or k_vt.shape != (b, kvh, r, hd) or v_vt.shape != k_vt.shape:
        raise ValueError("factor shapes do not match the cache")
    if on_card and (write_pos.numel() != 1 or write_pos.dtype != torch.int32):
        raise TypeError(f"a device write_pos is one int32, got "
                        f"{write_pos.dtype} of shape {tuple(write_pos.shape)}")
    g = h // kvh
    plan = decode_plan(b, kvh, skv, hd, r, g, kv_bytes=k.element_size(),
                       grain=block_kv or GRAIN, splits=splits)
    comp = comp_len.to(device=q.device, dtype=torch.int32)
    operands = [("q", q), ("k", k), ("v", v), ("k_us", k_us), ("k_vt", k_vt),
                ("v_us", v_us), ("v_vt", v_vt), ("comp_len", comp)]
    if on_card:
        operands.append(("write_pos", write_pos))
    dev = q.get_device()
    for name, x in operands:   # the checks of check_launch_operand, cheaply
        if x.get_device() != dev or not x.is_contiguous() or x.data_ptr() % 16:
            _k.check_launch_operand(x, name, q.device)
    out = torch.empty_like(q)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    tickets, ws = _scratch_buffers(dev, stream, b * kvh, plan.workspace)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      k_us.data_ptr(), k_vt.data_ptr(), v_us.data_ptr(),
                      v_vt.data_ptr(), comp.data_ptr(),
                      write_pos.data_ptr() if on_card else None,
                      out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                      b, skv, h, kvh, hd, r, 0 if on_card else write_pos,
                      plan.grain, plan.splits, float(scale), float(cap),
                      int(q.dtype == torch.float32),
                      int(k.dtype == torch.float32), stream, dev)
    if err:
        raise RuntimeError(f"factored_decode kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _empty_launcher():
    fn = _build.load("factored_decode").factored_decode_empty_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def empty_launch(device=None) -> None:
    """One launch of an empty kernel on the current stream: the latency
    floor of a launch on this card, timed beside kernel 4.  Needs the card."""
    dev = torch.device(device or "cuda")
    err = _empty_launcher()(torch.cuda.current_stream(dev).cuda_stream,
                            dev.index or 0)
    if err:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")


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
