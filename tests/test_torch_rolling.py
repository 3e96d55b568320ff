"""The port's rolling (sliding-window) sketches (repro_torch.stream.rolling)
and the rolling KV sketches of repro_torch.serve.kv_compress against the
reference's, on the same inputs: the cases of tests/test_rolling.py, each
held both to the port's own contract (finalize == a fresh sketch of the
current window) and to the reference's finalized sketch.

Tolerances: finalize against the port's fresh window sketch at rtol = atol =
1e-6 (on the CPU the plain versions run torch.matmul, whose summation may
depend on the tile height; the card test in tests/test_torch_cuda.py holds
kernel 2 bit for bit); port against reference at rtol = atol = 1e-5 (the
reference's own legacy-method tolerance, tests/test_rolling.py), 1e-4 /
1e-5 with decay.  The non-fused methods' Omega is patched to the
reference's jax.random draws for the same key words (the port draws from the
counter lattice, a documented deviation); kernel 2's Omega is the same
lattice in both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import stream as rstream
from repro.core import projection as rproj
from repro.serve import kv_compress as rkv
from repro.stream import state as rstate
from repro_torch import stream
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.serve import kv_compress as kv

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

SEED = 7
KEY, JKEY = key_from_seed(SEED), jax.random.PRNGKey(SEED)
N, P, W = 24, 8, 16
A = np.random.default_rng(3).standard_normal((80, N)).astype(np.float32)
TILES = (3, 1, 7, 16, 9, 14, 10, 6, 8, 16)


def _patch_omega(port_state, ref_base, n=N, p=P):
    """Port state's Omega := the reference's jax.random draw for its key."""
    omega = rproj.materialize_omega(rstate._typed_key(ref_base.key_omega),
                                    (n, p), dtype=jnp.bfloat16)
    port_state.omega = from_reference(np.asarray(omega))


def _pair(method, **kw):
    rs = rstream.rolling_init(JKEY, N, P, window=kw.pop("window", W),
                              method=method, **kw)
    ps = stream.rolling_init(KEY, N, P, window=rs.window, method=method,
                             max_rows=rs.capacity, decay=rs.decay,
                             device="cpu")
    if method != "shgemm_fused":
        _patch_omega(ps.base, rs.base)
    return rs, ps


def _roll_both(rs, ps, rows, pos=0, tiles=(8,)):
    off, i = 0, 0
    while off < len(rows):
        c = min(tiles[i % len(tiles)], len(rows) - off)
        rs = rstream.rolling_update(rs, jnp.asarray(rows[off:off + c]), pos + off)
        ps = stream.rolling_update(ps, torch.tensor(rows[off:off + c]), pos + off)
        off, i = off + c, i + 1
    return rs, ps


def _fresh(ps, rows):
    """The port's fresh sketch of ``rows`` on the same Omega."""
    st = stream.init(KEY, N, P, max_rows=len(rows), method=ps.base.method,
                     device="cpu")
    st.omega = ps.base.omega
    return stream.update(st, torch.tensor(rows), 0)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["shgemm_fused", "shgemm"])
@pytest.mark.parametrize("total", [5, 16, 17, 40, 80])
def test_finalize_matches_fresh_window_sketch(method, total):
    rs, ps = _pair(method)
    rs, ps = _roll_both(rs, ps, A[:total], tiles=TILES)
    fin, ref = stream.rolling_finalize(ps), rstream.rolling_finalize(rs)
    live = min(total, W)
    assert fin.rows_seen == live == int(ref.rows_seen)
    assert fin.max_rows == W and ps.rows_seen == total
    want = torch.zeros((W, P))
    want[:live] = _fresh(ps, A[total - live:total]).y
    _close(fin.y, want.numpy(), rtol=1e-6, atol=1e-6)
    _close(fin.y, ref.y)


def test_finalize_is_a_plain_sketch_state():
    rs, ps = _pair("shgemm_fused")
    rs, ps = _roll_both(rs, ps, A[:40])
    fin = stream.rolling_finalize(ps)
    assert isinstance(fin, stream.SketchState)
    assert fin.max_rows == W and fin.p == P
    q = stream.range_basis(fin)
    assert tuple(q.shape) == (W, P)
    _close(q @ q.T, np.asarray(rstream.range_basis(rstream.rolling_finalize(rs))
                               @ rstream.range_basis(rstream.rolling_finalize(rs)).T),
           rtol=1e-4, atol=1e-4)
    win = torch.tensor(A[24:40])
    resid = win - q @ (q.T @ win)
    assert float(torch.linalg.norm(resid)) < float(torch.linalg.norm(win))
    # finalizing reads the ring and leaves it as it was
    ring = ps.base.y.clone()
    stream.rolling_finalize(ps)
    assert torch.equal(ps.base.y, ring)


def test_default_append_position():
    rs, ps = _pair("shgemm_fused")
    for lo, hi in ((0, 10), (10, 20)):
        rs = rstream.rolling_update(rs, jnp.asarray(A[lo:hi]))
        ps = stream.rolling_update(ps, torch.tensor(A[lo:hi]))
    fin = stream.rolling_finalize(ps)
    _close(fin.y, _fresh(ps, A[4:20]).y.numpy(), rtol=1e-6, atol=1e-6)
    _close(fin.y, rstream.rolling_finalize(rs).y)


def test_decay_weights_window_rows():
    g = 0.5
    rs, ps = _pair("shgemm", decay=g)
    rs, ps = _roll_both(rs, ps, A[:30])
    fin = stream.rolling_finalize(ps)
    age = np.arange(W - 1, -1, -1, dtype=np.float32)
    want = _fresh(ps, A[30 - W:30] * (g ** age)[:, None])
    _close(fin.y, want.y.numpy(), rtol=1e-4, atol=1e-5)
    _close(fin.y, rstream.rolling_finalize(rs).y, rtol=1e-4, atol=1e-5)


def test_capacity_larger_than_window():
    rs, ps = _pair("shgemm_fused", window=8, max_rows=W)
    assert ps.capacity == W and ps.window == 8
    rs, ps = _roll_both(rs, ps, A[:20])
    fin = stream.rolling_finalize(ps)
    assert fin.max_rows == 8
    _close(fin.y, _fresh(ps, A[12:20]).y.numpy(), rtol=1e-6, atol=1e-6)
    _close(fin.y, rstream.rolling_finalize(rs).y)


def test_heads_batched_state():
    """The engine's per-head batching (the reference vmaps per-head states):
    head h of a heads= state against the reference's per-head state on the
    same Omega and rows."""
    heads, offs = 3, (0, 20, 40)
    ps = stream.rolling_init(KEY, N, P, window=W, method="shgemm", heads=heads,
                             device="cpu")
    refs = [rstream.rolling_init(k, N, P, window=W, method="shgemm")
            for k in jax.random.split(JKEY, heads)]
    ps.base.omega = torch.stack([
        from_reference(np.asarray(rproj.materialize_omega(
            rstate._typed_key(r.base.key_omega), (N, P), dtype=jnp.bfloat16)))
        for r in refs])
    rows = np.stack([A[o:o + 16] for o in offs])
    ps = stream.rolling_update(ps, torch.tensor(rows), 0)
    fin = stream.rolling_finalize(ps)
    assert tuple(fin.y.shape) == (heads, W, P)
    for h in range(heads):
        ref = rstream.rolling_finalize(
            rstream.rolling_update(refs[h], jnp.asarray(rows[h]), 0))
        _close(fin.y[h], ref.y)


def test_gap_rows_count_as_zero():
    rs, ps = _pair("shgemm_fused")
    rs, ps = _roll_both(rs, ps, A[:W])           # a full lap: every slot used
    gap_to = W + 6                               # skip positions [W, W+6)
    rs = rstream.rolling_update(rs, jnp.asarray(A[gap_to:gap_to + 4]), gap_to)
    ps = stream.rolling_update(ps, torch.tensor(A[gap_to:gap_to + 4]), gap_to)
    fin = stream.rolling_finalize(ps)
    lo = gap_to + 4 - W
    rows = np.zeros((W, N), np.float32)
    rows[:W - lo] = A[lo:W]
    rows[W - lo + 6:] = A[gap_to:gap_to + 4]
    want = _fresh(ps, rows).y
    assert not fin.y[W - lo:W - lo + 6].any()
    _close(fin.y, want.numpy(), rtol=1e-6, atol=1e-6)
    _close(fin.y, rstream.rolling_finalize(rs).y)


def test_kv_rolling_append_monotone_guard():
    for mod, key, arr in ((kv, KEY, torch.zeros), (rkv, JKEY, jnp.zeros)):
        extra = {"device": "cpu"} if mod is kv else {}
        st = mod.kv_rolling_init(key, 2, N, W, 4, **extra)
        st = mod.kv_rolling_append(st, arr((2, 4, N)), 0)
        with pytest.raises(ValueError, match="behind the rolling sketch"):
            mod.kv_rolling_append(st, arr((2, 4, N)), 1)
    st = kv.kv_rolling_init(KEY, 2, N, W, 4, device="cpu")
    with pytest.raises(ValueError, match="n_heads, T, head_dim"):
        kv.kv_rolling_append(st, torch.zeros((4, N)), 0)


def test_error_paths_no_silent_clamping():
    def init(**kw):
        return stream.rolling_init(KEY, N, kw.pop("p", P), device="cpu", **kw)
    with pytest.raises(ValueError, match="window 32 exceeds ring capacity"):
        init(window=32, max_rows=16)
    with pytest.raises(ValueError, match="must be positive"):
        init(window=0)
    with pytest.raises(ValueError, match="decay"):
        init(window=W, decay=1.5)
    with pytest.raises(ValueError, match="exceeds n_cols"):
        init(window=W, p=N + 1)
    rs = init(window=W)
    a = torch.tensor(A)
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        stream.rolling_update(rs, a[:W + 1], 0)
    with pytest.raises(ValueError, match="2-D row tile"):
        stream.rolling_update(rs, a[None, :4], 0)
    with pytest.raises(ValueError, match="columns"):
        stream.rolling_update(rs, a[:4, :N - 1], 0)
    rs = stream.rolling_update(rs, a[:10], 0)
    with pytest.raises(ValueError, match="monotone"):
        stream.rolling_update(rs, a[:2], 4)
    with pytest.raises(ValueError, match=">= 0"):
        stream.rolling_update(init(window=W), a[:2], -1)


def test_no_left_sketch_for_rolling():
    rs = stream.rolling_init(KEY, N, P, window=W, device="cpu")
    rs = stream.rolling_update(rs, torch.tensor(A[:W]), 0)
    fin = stream.rolling_finalize(rs)
    with pytest.raises(ValueError, match="left sketch"):
        stream.svd(fin, 4)


# -- the serving engine's rolling KV sketches ------------------------------

HEADS, HD, RANK = 3, 16, 4


def _kv_pair(window, decay=1.0):
    ref = rkv.kv_rolling_init(jax.random.PRNGKey(11), HEADS, HD, window, RANK,
                              decay=decay)
    port = kv.kv_rolling_init(key_from_seed(11), HEADS, HD, window, RANK,
                              decay=decay, device="cpu")
    p = kv._sketch_width(RANK, HD)
    port.base.omega = torch.stack([from_reference(np.asarray(
        rproj.materialize_omega(rstate._typed_key(ref.base.key_omega[h]), (HD, p),
                                dtype=jnp.bfloat16))) for h in range(HEADS)])
    return ref, port


@pytest.mark.parametrize("spans", [[(0, 12)], [(0, 5), (5, 16), (21, 1), (22, 1),
                                                (23, 9)], [(0, 16), (20, 9)]],
                         ids=["short", "wrapping", "gap"])
@pytest.mark.parametrize("decay", [1.0, 0.75])
def test_kv_rolling_matches_reference(spans, decay):
    """Rolling KV sketches appended span by span (rows older than the window
    clamped off, as the engine does), then the window's factors: sketch rows
    at 1e-5, reconstructions us @ vt at 1e-4 (the factors carry SVD sign
    freedom)."""
    window = 16
    hist = np.random.default_rng(5).standard_normal((HEADS, 40, HD)).astype(np.float32)
    ref, port = _kv_pair(window, decay)
    for start, length in spans:
        end = start + length
        lo = max(start, end - window)
        ref = rkv.kv_rolling_append(ref, jnp.asarray(hist[:, lo:end]), lo)
        port = kv.kv_rolling_append(port, torch.tensor(hist[:, lo:end]), lo)
    assert port.rows_seen == int(np.asarray(ref.rows_seen).max())
    _close(port.base.y, ref.base.y)
    end = spans[-1][0] + spans[-1][1]
    start = max(0, end - window)
    win = np.zeros((HEADS, window, HD), np.float32)
    win[:, :end - start] = hist[:, start:end]
    f_ref = rkv.kv_rolling_factor(ref, jnp.asarray(win), RANK)
    f = kv.kv_rolling_factor(port, torch.tensor(win), RANK)
    assert tuple(f.us.shape) == f_ref.us.shape == (HEADS, window, RANK)
    want = np.einsum("hsr,hrd->hsd", np.asarray(f_ref.us), np.asarray(f_ref.vt))
    _close(f.us @ f.vt, want, rtol=1e-4, atol=1e-4)


def test_compress_kv_cache_matches_reference():
    """One-shot per-(batch, head) factors of a rank-2 cache: both packages
    reconstruct it (their keys differ by design, so the factors are held
    through their reconstructions)."""
    rng = np.random.default_rng(8)
    b, s, kvh, hd, r = 2, 24, 2, 16, 4
    low = lambda: (rng.standard_normal((b, kvh, s, 2)) @ rng.standard_normal(
        (b, kvh, 2, hd))).transpose(0, 2, 1, 3).astype(np.float32)
    k, v = low(), low()
    ref = rkv.compress_kv_cache(jax.random.PRNGKey(3), jnp.asarray(k),
                                jnp.asarray(v), r)
    got = kv.compress_kv_cache(key_from_seed(3), torch.tensor(k), torch.tensor(v), r)
    for name, m in (("k", k), ("v", v)):
        f, fr = got[name], ref[name]
        assert tuple(f.us.shape) == fr[0].shape == (b, kvh, s, r)
        assert tuple(f.vt.shape) == fr[1].shape == (b, kvh, r, hd)
        want = np.einsum("bhsr,bhrd->bhsd", np.asarray(fr[0]), np.asarray(fr[1]))
        _close(f.us @ f.vt, want, rtol=1e-4, atol=1e-4)
        _close(f.us @ f.vt, m.transpose(0, 2, 1, 3), rtol=1e-4, atol=1e-4)
