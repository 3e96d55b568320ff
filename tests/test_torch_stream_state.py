"""stream/state.py, finalize.py and tucker.py against the reference on the
same inputs: streamed right sketches Y (row tiles, regular and ragged),
left sketches W at any row offset, ``update_cols``, ``merge``, ``widen`` +
``hstack``, the single-pass ``svd``, ``psi_times`` and the streaming-Tucker
sketches.  The port derives Psi's and Tucker's keys with ``fold_in_words``
(a documented deviation from ``jax.random.fold_in``); here it is replaced
by the words of the reference's fold_in, and the non-fused methods' Omega by
the reference's jax.random Omega.  Tolerances are those of the reference's
own tests (rtol 1e-5, atol 1e-4 for accumulated sketches)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stream as rstream
from repro.core import projection as ref_proj
from repro.stream import state as ref_state
from repro_torch import stream
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import projection as proj
from repro_torch.stream import state as st_mod

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

SEED = 42
KEY = key_from_seed(SEED)
JKEY = jax.random.PRNGKey(SEED)
M, N, P = 96, 80, 12


@pytest.fixture
def reference_draws(monkeypatch):
    """fold_in words := the reference's jax.random.fold_in words; the legacy
    Omega := the reference's jax.random Omega for the same key words."""
    def fold_in_words(key, data):
        jkey = jnp.asarray(np.array(key, np.uint32))
        return tuple(int(w) for w in np.asarray(
            ref_state._raw_key(jax.random.fold_in(jkey, data))))

    def materialize(key, shape, *, dist="gaussian", s=None,
                    dtype=torch.bfloat16, device=None):
        jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
               torch.float32: jnp.float32}[dtype]
        omega = ref_proj.materialize_omega(jnp.asarray(np.array(key, np.uint32)),
                                           shape, dist=dist, s=s, dtype=jdt)
        return from_reference(np.asarray(omega)).to(device)
    monkeypatch.setattr(st_mod, "fold_in_words", fold_in_words)
    monkeypatch.setattr(proj, "materialize_omega", materialize)


def _a(m=M, n=N, seed=1):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


def _offsets(m, tile):
    return list(range(0, m, tile))


def _port_rows(a, p, tile, **kw):
    st = stream.init(KEY, a.shape[1], p, max_rows=a.shape[0], device="cpu", **kw)
    for off in _offsets(a.shape[0], tile):
        stream.update(st, torch.from_numpy(a[off:off + tile]), off)
    return st


def _ref_rows(a, p, tile, **kw):
    st = rstream.init(JKEY, a.shape[1], p, max_rows=a.shape[0], **kw)
    for off in _offsets(a.shape[0], tile):
        st = rstream.update(st, jnp.asarray(a[off:off + tile]), off)
    return st


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


CASES = [("shgemm_fused", "gaussian"), ("shgemm_fused", "very_sparse"),
         ("shgemm_fused", "srht"), ("f32", "gaussian"), ("shgemm", "gaussian"),
         ("shgemm_pallas", "achlioptas")]


@pytest.mark.parametrize("method,dist", CASES)
@pytest.mark.parametrize("tile", [32, 40])
def test_streamed_rows_match_reference(reference_draws, method, dist, tile):
    a = _a()
    got = _port_rows(a, P, tile, method=method, dist=dist)
    want = _ref_rows(a, P, tile, method=method, dist=dist)
    _close(got.y, want.y)
    assert got.rows_seen == int(want.rows_seen) == M
    assert (got.omega is None) == (method == "shgemm_fused" or dist == "srht")
    # streamed rows are the one-shot sketch's rows (bit for bit on the card;
    # the CPU's plain GEMM leaves the row blocking to the BLAS)
    one = proj.sketch(KEY, torch.from_numpy(a), P, method=method, dist=dist,
                      device="cpu")
    tol = 0 if dist == "srht" else 1e-6
    torch.testing.assert_close(got.y, one, rtol=tol, atol=tol)


@pytest.mark.parametrize("method,dist", [("shgemm_fused", "gaussian"),
                                         ("shgemm_fused", "very_sparse"),
                                         ("shgemm", "gaussian")])
@pytest.mark.parametrize("tile", [32, 40, 96])
def test_left_sketch_matches_reference(reference_draws, method, dist, tile):
    """W at row offsets 40, 80 (off kernel 2's bk grid) and 32, 64."""
    a = _a()
    got = _port_rows(a, P, tile, left=True, method=method, dist=dist)
    want = _ref_rows(a, P, tile, left=True, method=method, dist=dist)
    assert got.l == want.l == 2 * P + 1 and got.key_psi is not None
    _close(got.w, want.w)
    _close(got.y, want.y)


@pytest.mark.parametrize("row_offset", [0, 40, 256, 300])
def test_fused_at_row_offset_is_the_offset_lattice(row_offset):
    """Kernel 2 at any row offset: the product with the lattice's rows
    [row_offset, row_offset + k), whatever bk grid the offset lies on."""
    a = torch.from_numpy(_a(24, 72))
    got = st_mod.fused_at_row_offset(a, KEY, 20, row_offset, col_offset=5)
    om = proj.fused_omega(KEY, (row_offset + 72, 25), device="cpu")[row_offset:, 5:]
    torch.testing.assert_close(got, a @ om.float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method,dist", [("shgemm_fused", "gaussian"),
                                         ("shgemm", "gaussian"),
                                         ("shgemm_fused", "srht")])
def test_update_cols_matches_reference(reference_draws, method, dist):
    n = 96
    a = _a(n, n, seed=4)
    left = dist != "srht"
    h = n // 2
    got = stream.init(KEY, n, P, max_rows=n, left=left, method=method,
                      dist=dist, device="cpu")
    want = rstream.init(JKEY, n, P, max_rows=n, left=left, method=method, dist=dist)
    for r0, c0 in [(h, h), (0, 0), (h, 0), (0, h)]:
        blk = a[r0:r0 + h, c0:c0 + h]
        stream.update_cols(got, torch.from_numpy(blk), r0, c0)
        want = rstream.update_cols(want, jnp.asarray(blk), r0, c0)
    _close(got.y, want.y)
    if left:
        _close(got.w, want.w)
    full = _port_rows(a, P, n, left=left, method=method, dist=dist)
    torch.testing.assert_close(got.y, full.y, rtol=1e-5, atol=1e-4)


def test_merge_algebra(reference_draws):
    a = _a(96, 64, seed=5)

    def part(lo, hi):
        s = stream.init(KEY, 64, P, max_rows=96, left=True,
                        method="shgemm_fused", device="cpu")
        for off in range(lo, hi, 32):
            stream.update(s, torch.from_numpy(a[off:off + 32]), off)
        return s
    s1, s2, s3 = part(0, 32), part(32, 64), part(64, 96)
    ab, ba = stream.merge(s1, s2), stream.merge(s2, s1)
    torch.testing.assert_close(ab.y, ba.y, rtol=0, atol=0)
    torch.testing.assert_close(ab.w, ba.w, rtol=0, atol=0)
    left = stream.merge(stream.merge(s1, s2), s3)
    right = stream.merge(s1, stream.merge(s2, s3))
    torch.testing.assert_close(left.y, right.y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(left.w, right.w, rtol=1e-6, atol=1e-6)
    seq = _port_rows(a, P, 32, left=True, method="shgemm_fused")
    torch.testing.assert_close(left.y, seq.y, rtol=0, atol=0)
    assert left.rows_seen == 96
    r = [rstream.update(rstream.init(JKEY, 64, P, max_rows=96, left=True),
                        jnp.asarray(a[o:o + 32]), o) for o in (0, 32, 64)]
    want = rstream.merge(rstream.merge(r[0], r[1]), r[2])
    _close(left.w, want.w)
    _close(left.y, want.y)


def test_merge_rejects_mismatched_states():
    s1 = stream.init(KEY, 64, 8, max_rows=32, left=True, device="cpu")
    with pytest.raises(ValueError, match="p differs"):
        stream.merge(s1, stream.init(KEY, 64, 12, max_rows=32, left=True, device="cpu"))
    with pytest.raises(ValueError, match="max_rows differs"):
        stream.merge(s1, stream.init(KEY, 64, 8, max_rows=64, left=True, device="cpu"))
    with pytest.raises(ValueError, match="Omega keys"):
        stream.merge(s1, stream.init(key_from_seed(7), 64, 8, max_rows=32,
                                     left=True, device="cpu"))
    with pytest.raises(ValueError, match="left"):
        stream.merge(s1, stream.init(KEY, 64, 8, max_rows=32, device="cpu"))


def test_widen_hstack_bit_identical_to_fresh(reference_draws):
    a = _a(96, 112, seed=6)
    p0, e1, e2 = 10, 7, 5
    base = _port_rows(a, p0, 28, method="shgemm_fused")
    grown = stream.hstack(base, _drain(base.widen(e1), a))
    fresh = proj.sketch(KEY, torch.from_numpy(a), p0 + e1, method="shgemm_fused",
                        device="cpu")
    torch.testing.assert_close(grown.y, fresh, rtol=1e-6, atol=1e-6)
    grown2 = stream.hstack(grown, _drain(grown.widen(e2), a))
    assert grown2.p == p0 + e1 + e2 and grown2.col_base == 0
    ref = rstream.init(JKEY, 112, p0, max_rows=96, method="shgemm_fused")
    ref = rstream.hstack(ref, ref.widen(e1 + e2))
    ref_full = _ref_rows(a, p0 + e1 + e2, 28, method="shgemm_fused")
    _close(grown2.y, ref_full.y)
    assert ref.p == grown2.p


def _drain(st, a, tile=28):
    for off in range(0, a.shape[0], tile):
        stream.update(st, torch.from_numpy(a[off:off + tile]), off)
    return st


def test_widen_and_hstack_validation():
    a = _a(96, 112, seed=6)
    base = _port_rows(a, 10, 28, method="shgemm_fused")
    with pytest.raises(ValueError, match="extra_cols"):
        base.widen(0)
    with pytest.raises(ValueError, match="exceeds"):
        base.widen(112)
    with pytest.raises(ValueError, match="shgemm_fused"):
        stream.init(KEY, 112, 10, max_rows=96, method="shgemm", device="cpu").widen(4)
    with pytest.raises(ValueError, match="SRHT"):
        stream.init(KEY, 112, 10, max_rows=96, method="shgemm_fused", dist="srht",
                    device="cpu").widen(4)
    with pytest.raises(ValueError, match="left-sketching"):
        stream.init(KEY, 112, 10, max_rows=96, left=True, method="shgemm_fused",
                    device="cpu").widen(4)
    ext = _drain(base.widen(4), a)
    with pytest.raises(ValueError, match="contiguous"):
        stream.hstack(base, ext.widen(2))
    other = _port_rows(a, 10, 28, method="shgemm_fused")
    other.key_omega = key_from_seed(7)
    with pytest.raises(ValueError, match="Omega keys"):
        stream.hstack(other, ext)
    short = stream.update(base.widen(4), torch.from_numpy(a[:28]), 0)
    with pytest.raises(ValueError, match="replay"):
        stream.hstack(base, short)
    assert stream.hstack(base, ext).p == 14


@pytest.mark.parametrize("method", ["shgemm_fused", "shgemm"])
def test_single_pass_svd_matches_reference(reference_draws, method):
    s = np.geomspace(1.0, 1e-3, 64).astype(np.float32)
    rng = np.random.default_rng(8)
    u, _ = np.linalg.qr(rng.standard_normal((128, 64)))
    v, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    a = ((u * s) @ v.T).astype(np.float32)
    got_st = _port_rows(a, 18, 40, left=True, method=method)
    want_st = _ref_rows(a, 18, 40, left=True, method=method)
    got, want = stream.svd(got_st, 8), rstream.svd(want_st, 8)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4,
                               atol=1e-6 * float(want.s[0]))
    err = lambda r: np.linalg.norm(a - (np.asarray(r.u) * np.asarray(r.s)) @ np.asarray(r.vt))
    np.testing.assert_allclose(err(got), err(want), rtol=1e-3)
    q = stream.range_basis(got_st)
    _close(stream.psi_times(got_st, q),
           rstream.finalize.psi_times(want_st, rstream.range_basis(want_st)),
           rtol=1e-4, atol=1e-4)


def test_svd_and_psi_times_need_the_left_sketch():
    st = stream.init(KEY, 64, 8, max_rows=32, device="cpu")
    with pytest.raises(ValueError, match="left=True"):
        stream.svd(st, 4)
    with pytest.raises(ValueError, match="left sketch"):
        stream.psi_times(st, torch.zeros((32, 8)))
    with pytest.raises(ValueError, match="exceeds sketch width"):
        stream.svd(stream.init(KEY, 64, 8, max_rows=32, left=True, device="cpu"), 9)


def test_init_and_update_errors():
    with pytest.raises(ValueError, match="exceeds n_cols"):
        stream.init(KEY, 8, 9, max_rows=4, device="cpu")
    with pytest.raises(ValueError, match="unknown streaming method"):
        stream.init(KEY, 8, 4, max_rows=4, method="tf32", device="cpu")
    with pytest.raises(ValueError, match="cannot left-sketch"):
        stream.init(KEY, 8, 4, max_rows=4, left=True, dist="srht", device="cpu")
    with pytest.raises(ValueError, match="tensor-mode family"):
        stream.init(KEY, 8, 4, max_rows=4, dist="khatri_rao", device="cpu")
    for kw in (dict(dist="srht"), dict(left=True, method="shgemm_fused")):
        with pytest.raises(ValueError, match="heads="):
            stream.init(KEY, 8, 4, max_rows=4, heads=2, device="cpu", **kw)
    a = torch.from_numpy(_a(32, 64))
    st = stream.init(KEY, 48, 8, max_rows=96, device="cpu")
    with pytest.raises(ValueError, match="64 columns.*48"):
        stream.update(st, a, 0)
    with pytest.raises(ValueError, match="dims"):
        stream.update(st, a[0], 0)
    with pytest.raises(ValueError, match="overrun"):
        stream.update(st, a[:, :48], 80)
    with pytest.raises(ValueError, match=">= 0"):
        stream.update(st, a[:, :48], -32)
    with pytest.raises(ValueError, match="col_offset.*overrun"):
        stream.update_cols(st, a[:16, :32], 0, 32)
    with pytest.raises(ValueError, match="row_offset.*overrun"):
        stream.update_cols(st, a[:16, :32], 88, 0)
    # the collective merge needs a torch.distributed world (its results:
    # tests/test_torch_distributed.py)
    with pytest.raises(RuntimeError, match="init_process_group"):
        stream.merge_across_hosts(st)


def test_fold_in_words():
    w = st_mod.fold_in_words(KEY, 0x5117)
    assert w == st_mod.fold_in_words((KEY[0], KEY[1]), 0x5117)
    assert all(0 <= x < 2**32 for x in w)
    assert len({w, st_mod.fold_in_words(KEY, 0), st_mod.fold_in_words(KEY, 1),
                st_mod.fold_in_words(key_from_seed(43), 0x5117), KEY}) == 5


@pytest.mark.parametrize("method,dist", [("shgemm_fused", "gaussian"),
                                         ("shgemm", "gaussian"),
                                         ("shgemm_fused", "khatri_rao")])
def test_tucker_sketch_matches_reference(reference_draws, method, dist):
    dims, ranks, slab = (12, 10, 8), (3, 3, 3), 4
    t = np.random.default_rng(9).standard_normal(dims).astype(np.float32)
    got = stream.tucker_init(KEY, dims, ranks, method=method, dist=dist, device="cpu")
    want = rstream.tucker_init(JKEY, dims, ranks, method=method, dist=dist)
    for off in (8, 0, 4):                  # slab order is free
        stream.tucker_update(got, torch.from_numpy(t[off:off + slab]), off)
        want = rstream.tucker_update(want, jnp.asarray(t[off:off + slab]), off)
    for g, w in zip(got.modes, want.modes):
        _close(g.y, w.y)
    _close(got.z, want.z)
    assert got.core_dims == want.core_dims and got.rows_seen == 12
    res, ref = stream.tucker(got), rstream.tucker(want)
    np.testing.assert_allclose(np.linalg.norm(res.core.numpy()),
                               np.linalg.norm(np.asarray(ref.core)), rtol=1e-3)
    # merge of disjoint slab sets == one sketch over all of them
    t1 = stream.tucker_init(KEY, dims, ranks, method=method, dist=dist, device="cpu")
    t2 = stream.tucker_init(KEY, dims, ranks, method=method, dist=dist, device="cpu")
    stream.tucker_update(t1, torch.from_numpy(t[:4]), 0)
    for off in (4, 8):
        stream.tucker_update(t2, torch.from_numpy(t[off:off + 4]), off)
    merged = stream.tucker_merge(t1, t2)
    torch.testing.assert_close(merged.z, got.z, rtol=1e-5, atol=1e-5)
    for m, g in zip(merged.modes, got.modes):
        torch.testing.assert_close(m.y, g.y, rtol=1e-5, atol=1e-5)


def test_tucker_errors():
    with pytest.raises(ValueError, match="srht"):
        stream.tucker_init(KEY, (4, 4), (2, 2), dist="srht", device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        stream.tucker_init(KEY, (4, 4), (2,), device="cpu")
    ts = stream.tucker_init(KEY, (4, 4, 4), (2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="trailing axes"):
        stream.tucker_update(ts, torch.zeros((2, 4, 3)), 0)
    with pytest.raises(ValueError, match="ranks differs"):
        stream.tucker_merge(ts, stream.tucker_init(KEY, (4, 4, 4), (2, 2, 3),
                                                   device="cpu"))
