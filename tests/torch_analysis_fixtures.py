"""Seeded-violation fixtures for the port's contract checker
(tests/test_torch_analysis.py).

One deliberate violation of each of ``repro_torch.analysis``'s rules, used
to prove the passes, the launch audit and the lint fire on exactly the
patterns they claim to catch, beside the sanctioned pattern of each.  This
module is not in the checker's default scope (``src/repro_torch``,
``chip_smoke.py``) — do not "fix" these.  ``LINT-HOST-SYNC`` applies under
a ``models/`` directory only: the tests lint a copy of this file there.
"""

import json
import time

import numpy as np
import torch

from repro_torch.kernels._grid import Launch, LaunchPlan, Write


def _gen(key) -> torch.Generator:
    return torch.Generator().manual_seed((key[0] << 32) | key[1])


# --- TORCH-NO-GEMM: an "SRHT-style" structured apply that cheats with a GEMM
def bad_srht_apply(key, a, p=4):
    signs = torch.where(torch.rand(a.shape[1], generator=_gen(key)) < 0.5,
                        1.0, -1.0)
    omega = torch.eye(a.shape[1], p) * signs[:, None]
    return a @ omega                  # the contract says adds/gathers only


def ok_structured_apply(key, a, p=4):
    signs = torch.where(torch.rand(a.shape[1], generator=_gen(key)) < 0.5,
                        1.0, -1.0)
    return (a * signs)[:, :p]


# --- TORCH-DTYPE-CAST: f16 cast on the A path (bf16-mode contract)
def bad_a_downcast(a, omega):
    return a.to(torch.float16).float() @ omega.to(torch.bfloat16).float()


# --- TORCH-DTYPE-CAST through copy_: a narrower destination is a cast too
def bad_copy_downcast(a):
    out = torch.empty(a.shape, dtype=torch.float16)
    out.copy_(a)
    return out


# --- TORCH-F64: a float64 result on a labelled path
def bad_f64(a):
    return a.to(torch.float64).sum()


# --- TORCH-WEAK-PROMOTE: a Python scalar mixes into the accumulation
def bad_weak_accumulate(b, blk):
    return b * 0.5 + blk


def ok_pinned_accumulate(b, blk):
    return b + blk


# --- TORCH-UNKEYED: randomness from the global generator
def bad_unkeyed(x):
    return x + torch.randn(x.shape)


def ok_keyed(key, x):
    return x + torch.randn(x.shape, generator=_gen(key))


# --- TORCH-UNKEYED: a key that reaches no draw
def bad_key_ignored(key, x):
    return x * 2.0


# --- TORCH-NONDET: an accumulating float scatter (atomics on CUDA)
def bad_scatter_add(x, idx):
    return torch.zeros(4).index_add_(0, idx, x)


# --- CUDA-WRITE-ALIAS: every block of a 2 x 2 grid writes tile (0, 0)
def bad_alias_grid() -> LaunchPlan:
    return LaunchPlan(
        (Launch("copy_kernel", (2, 2),
                lambda idx: [Write("out", (slice(0, 8), slice(0, 8)))]),),
        {"out": (16, 16)}, ("out",))


# --- CUDA-COVERAGE: the grid misses the last tile column
def bad_uncovered_grid() -> LaunchPlan:
    return LaunchPlan(
        (Launch("copy_kernel", (1, 2),
                lambda idx: [Write("out", (slice(8 * idx[1], 8 * idx[1] + 8),
                                           slice(8 * idx[0], 8 * idx[0] + 8)))]),),
        {"out": (16, 16)}, ("out",))


def ok_tiled_grid() -> LaunchPlan:
    return LaunchPlan(
        (Launch("copy_kernel", (2, 2),
                lambda idx: [Write("out", (slice(8 * idx[1], 8 * idx[1] + 8),
                                           slice(8 * idx[0], 8 * idx[0] + 8)))]),),
        {"out": (16, 16)}, ("out",))


# --- CUDA-SMEM: a block above sm_90's opt-in limit
BAD_SMEM = [("a 256 x 256 f32 tile ring of 2", 2 * 256 * 256 * 4)]


# --- LINT-ATOMIC-IO: non-atomic report write
def bad_report_write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)


# --- LINT-NP-RANDOM: global-state numpy randomness
def bad_np_random(n):
    return np.random.rand(n)


# --- LINT-WALLCLOCK: wall clock used for a duration
def bad_duration():
    t0 = time.time()
    return time.time() - t0


# --- LINT-HOST-SYNC: a decode step reads its clock and a flag back
def bad_host_sync(x, write_pos, mask):
    if bool(mask.any()):
        return x[:, : int(write_pos)].sum().item()
    last = int(x[x.shape[0] - 1])     # an element, indexed by a shape
    return last + int(x.get_pos())


def ok_host_values(x, cfg, n_tokens):
    rows, cols = x.shape
    width = int(cfg.d_model * 2) + int(x.shape[0] - 1) + int(x.size(1))
    return len(x) + round(2.5) + int(3) + float("1e-3") + rows + width + cols
