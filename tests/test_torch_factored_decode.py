"""Kernel 4's plain version (the port's ``models.layers.
factored_decode_attention``, which ``kernels.factored_decode`` runs on CPU
tensors) against the reference's jnp oracle and its Pallas kernel in
interpret mode, on the same numpy inputs, at <= 1e-5: the sweep of the
reference's tests/test_factored_decode_kernel.py."""

import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import factored_decode as rfd
from repro.models import layers as RL
from repro_torch.kernels import factored_decode as k4
from repro_torch.kernels import ops
from repro_torch.models import layers as PL

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(b=2, s=32, h=4, kvh=2, hd=16, r=5, comp=(12, 0), wp=20, seed=23,
            garbage_past_wp=False):
    """numpy state honoring the cache contract: us rows >= comp_len zero,
    dense rows < comp_len zero (swapped out)."""
    rng = np.random.default_rng(seed)
    rn = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    comp = np.asarray(comp, np.int32)
    idx = np.arange(s)
    pre = idx[None, :] < comp[:, None]
    us_k = rn(b, kvh, s, r) * pre[:, None, :, None]
    us_v = rn(b, kvh, s, r) * pre[:, None, :, None]
    vt_k, vt_v = rn(b, kvh, r, hd), rn(b, kvh, r, hd)
    kd = np.where(pre[..., None, None], 0.0, rn(b, s, kvh, hd)).astype(np.float32)
    vd = np.where(pre[..., None, None], 0.0, rn(b, s, kvh, hd)).astype(np.float32)
    if not garbage_past_wp:
        dead = (idx > wp)[None, :, None, None]
        kd, vd = np.where(dead, 0.0, kd), np.where(dead, 0.0, vd)
    q = rn(b, 1, h, hd)
    return q, kd.astype(np.float32), vd.astype(np.float32), us_k, vt_k, us_v, vt_v, comp


def _port(args, wp, *, cap=0.0, hd=16, block_kv=None):
    t = [torch.tensor(a) for a in args]
    return ops.factored_decode_attention(*t, wp, scale=1 / math.sqrt(hd),
                                         cap=cap, block_kv=block_kv).numpy()


def _ref(args, wp, *, cap=0.0, hd=16, block_kv=8):
    j = [jnp.asarray(a) for a in args]
    scale = 1 / math.sqrt(hd)
    oracle = RL.factored_decode_attention(*j, write_pos=wp, scale=scale, cap=cap)
    kern = rfd.factored_decode_attention(*j, wp, scale=scale, cap=cap,
                                         block_kv=block_kv, interpret=True)
    return np.asarray(oracle), np.asarray(kern)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_gqa_softcap(h, kvh, cap):
    args = _inputs(h=h, kvh=kvh, comp=(12, 5), wp=20)
    got = _port(args, 20, cap=cap)
    for want in _ref(args, 20, cap=cap):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("comp", [(0, 0), (21, 21), (12, 0), (8, 21)],
                         ids=["none", "all", "mixed", "mixed_boundary"])
def test_comp_len_sweep(comp):
    args = _inputs(comp=comp, wp=20)
    got = _port(args, 20)
    for want in _ref(args, 20):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("block_kv", [8, 16, 32, 64])
def test_block_size(block_kv):
    args = _inputs(s=40, comp=(13, 0), wp=25)
    got = _port(args, 25, block_kv=block_kv)
    for want in _ref(args, 25, block_kv=block_kv):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("wp", [7, 8, 31])
def test_write_pos_boundary(wp):
    args = _inputs(comp=(4, 2), wp=wp)
    got = _port(args, wp)
    for want in _ref(args, jnp.asarray(wp, jnp.int32)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_reused_slot_garbage_invariance():
    wp = 17
    clean = _inputs(comp=(9, 0), wp=wp)
    dirty = _inputs(comp=(9, 0), wp=wp, garbage_past_wp=True)
    got_d = _port(dirty, wp)
    for want in _ref(dirty, wp):
        np.testing.assert_allclose(got_d, want, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(_port(clean, wp), got_d, atol=ATOL, rtol=1e-5)


def test_zero_comp_never_reads_factors():
    """comp_len == 0 everywhere: factors that break the zeroed-rows contract
    (or hold NaN) change no bit of the output."""
    args = list(_inputs(comp=(0, 0), wp=20))
    out = _port(tuple(args), 20)
    for fill in (7.0, float("nan")):
        poisoned = list(args)
        for i in (3, 4, 5, 6):
            poisoned[i] = np.full_like(args[i], fill)
        np.testing.assert_array_equal(_port(tuple(poisoned), 20), out)


def _always_both_paths(q, k, v, k_us, k_vt, v_us, v_vt, comp_len, *,
                       write_pos, scale, cap=0.0):
    """The oracle computing the factored einsums for every position: the
    bitwise reference of the dense-only short-circuit."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, hd)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    s_dense = torch.einsum("bkgd,bksd->bkgs", qf, kf) * scale
    qv = torch.einsum("bkgd,bkrd->bkgr", qf, k_vt)
    s_fact = torch.einsum("bkgr,bksr->bkgs", qv, k_us) * scale
    idx = torch.arange(skv)
    prefix = idx[None, :] < comp_len[:, None].long()
    valid = (idx[None, :] <= write_pos).expand_as(prefix)
    scores = torch.where(prefix[:, None, None], s_fact, s_dense)
    scores = PL.softcap(scores, cap)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, PL.NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    w_pre = probs * prefix[:, None, None]
    w_tail = probs * (valid & ~prefix)[:, None, None]
    out = torch.einsum("bkgs,bksr->bkgr", w_pre, v_us)
    out = torch.einsum("bkgr,bkrd->bkgd", out, v_vt)
    out = out + torch.einsum("bkgs,bksd->bkgd", w_tail, vf)
    return out.reshape(b, sq, h, hd).to(q.dtype)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("comp", [(0, 0), (12, 5)])
def test_dense_only_short_circuit_bitwise(cap, comp):
    t = [torch.tensor(a) for a in _inputs(comp=comp, wp=20)]
    kw = dict(write_pos=20, scale=0.25, cap=cap)
    np.testing.assert_array_equal(PL.factored_decode_attention(*t, **kw).numpy(),
                                  _always_both_paths(*t, **kw).numpy())


# Kernel 4's launch plan: the grid and the workspace are functions of the
# shapes alone, and at every clock the splits cover the live rows once.

ENGINE = dict(b=8, kvh=8, s=2048, hd=128, r=32, g=2)   # qwen3-0.6b engine


def test_decode_plan_takes_no_clock():
    assert "write_pos" not in inspect.signature(k4.decode_plan).parameters
    plan = k4.decode_plan(**ENGINE)
    b, kvh, g, hd, r = 8, 8, 2, 128, 32
    assert plan.workspace == b * kvh * plan.splits * g * (2 + hd + r)
    assert plan.grain == k4.GRAIN == 8
    assert plan.smem == k4.smem_bytes(g, hd, r, plan.splits, 2)
    assert plan.smem <= k4.SMEM_LIMIT


def test_decode_plan_fills_the_card_at_the_engine_shape():
    """>= 2 blocks an SM of the H100's 132 at 8 slots x 8 kv heads."""
    plan = k4.decode_plan(**ENGINE)
    assert plan.splits * 8 * 8 >= 2 * 132


@pytest.mark.parametrize("s,grain,splits", [
    (2048, 8, None), (40, 8, None), (40, 8, 1), (40, 8, 10), (33, 8, 3),
    (100, 16, 4), (7, 8, 2), (1, 8, 5)], ids=str)
def test_split_bounds_cover_the_live_rows_once(s, grain, splits):
    plan = k4.decode_plan(2, 2, s, 16, 5, 2, grain=grain, splits=splits)
    for wp in range(s):
        bounds = k4.split_bounds(plan, wp)
        assert len(bounds) == plan.splits
        rows = [i for start, end in bounds for i in range(start, end)]
        assert rows == list(range(wp + 1))
        share = -(-(-(-(wp + 1) // grain)) // plan.splits) * grain
        for start, end in bounds:
            assert end - start <= share
            if end > start:                    # empty shares sit at the back
                assert start % grain == 0
                assert end == wp + 1 or end % grain == 0


def test_decode_plan_shared_memory_does_not_follow_the_cache():
    """A block stages its share a chunk at a time: its shared memory is the
    same for a 2k and a 32k slot, and one split of a 32k slot fits."""
    short = k4.decode_plan(8, 8, 2048, 128, 32, 2, splits=1)
    long = k4.decode_plan(8, 8, 32768, 128, 32, 2, splits=1)
    assert short.smem == long.smem <= k4.SMEM_LIMIT
    assert k4.decode_plan(8, 8, 2048, 128, 32, 2, kv_bytes=4).smem <= k4.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        k4.decode_plan(1, 1, 2048, 128, 32, 2, splits=100000)


@pytest.mark.parametrize("wp", [0, 7, 25])
def test_tensor_write_pos_matches_int(wp):
    """A 0-d int tensor clock on the CPU path equals the int path and the
    reference's oracle and Pallas kernel (interpret mode) at 1e-5."""
    args = _inputs(s=40, comp=(min(13, wp + 1), 0), wp=wp)
    t = [torch.tensor(a) for a in args]
    kw = dict(scale=0.25, cap=0.0)
    by_int = k4.factored_decode_attention(*t, wp, **kw).numpy()
    for clock in (torch.tensor(wp), torch.tensor(wp, dtype=torch.int32)):
        got = k4.factored_decode_attention(*t, clock, **kw).numpy()
        np.testing.assert_array_equal(got, by_int)
    for want in _ref(args, wp):
        np.testing.assert_allclose(by_int, want, atol=ATOL, rtol=1e-5)


def test_bound_counts_follow_the_data():
    """bytes/operations count the live rows only: past write_pos nothing,
    prefix rows at rank r, tail rows at head_dim."""
    q, k, _, us, *_ = (torch.tensor(a) for a in _inputs(comp=(12, 0), wp=20))
    comp = torch.tensor([12, 0])
    kvh, hd, r = 2, 16, 5
    dense_rows, fact_rows = (21 - 12) + 21, 12
    assert k4.bytes_needed(q, k, us, comp, 20) == (
        2 * 2 * 4 * hd * 4 + 2 * dense_rows * kvh * hd * 4
        + 2 * fact_rows * kvh * r * 4 + 2 * 1 * kvh * r * hd * 4)
    g = 2
    ops_ = kvh * g * ((9 * 2 * hd + 12 * 2 * r) + 2 * r * hd) + kvh * g * 21 * 2 * hd
    assert k4.operations_needed(q, k, us, comp, 20) == 2 * ops_


def test_wrapper_checks():
    q, k, v, us_k, vt_k, us_v, vt_v, comp = (torch.tensor(a) for a in _inputs())
    with pytest.raises(ValueError, match="single-token"):
        k4.factored_decode_attention(q.expand(2, 2, 4, 16), k, v, us_k, vt_k,
                                     us_v, vt_v, comp, 20, scale=0.25)
    with pytest.raises(ValueError, match="outside the cache"):
        k4.factored_decode_attention(q, k, v, us_k, vt_k, us_v, vt_v, comp,
                                     32, scale=0.25)
    meta = [x.to("meta") for x in (q, k, v, us_k, vt_k, us_v, vt_v, comp)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k4.factored_decode_attention(*meta, 20, scale=0.25)
