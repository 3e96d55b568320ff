"""The streamed drivers against the reference on the same inputs:
``rsvd_streamed`` (passes 1, 2 and 4, adaptive widening) and
``rp_sthosvd_streamed`` (Gaussian and Khatri-Rao).  Keys derived with
``fold_in_words`` and the non-fused methods' Omega are replaced by the
reference's draws (documented deviations).  Singular values are held as in
``tests/test_torch_rsvd.py``, reconstruction errors at rtol 1e-3, and the
integer fields of ``AdaptiveInfo`` exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stream as rstream
from repro.core import hosvd as ref_hosvd
from repro.core import projection as ref_proj
from repro.core import rsvd as ref_rsvd
from repro.stream import state as ref_state
from repro_torch import stream
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import hosvd, projection as proj, rsvd
from repro_torch.stream import state as st_mod

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

SEED = 5
KEY = key_from_seed(SEED)
JKEY = jax.random.PRNGKey(SEED)
N, RANK, TILE = 128, 12, 40        # ragged: 40 + 40 + 40 + 8 rows


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


@pytest.fixture(scope="module")
def a_exp():
    s = ref_rsvd.singular_values_exp(N, RANK, 1e-3)
    return np.array(ref_rsvd.matrix_with_singular_values(jax.random.PRNGKey(0), N, s))


def _svals_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want[0])


def _err(a, res):
    return float(rsvd.reconstruction_error(torch.from_numpy(a), res))


def _ref_err(a, res):
    return float(ref_rsvd.reconstruction_error(jnp.asarray(a), res))


@pytest.mark.parametrize("method", ["shgemm_fused", "shgemm", "shgemm_pallas"])
@pytest.mark.parametrize("passes", [1, 2, 4])
def test_rsvd_streamed_matches_reference(reference_draws, a_exp, method, passes):
    want = ref_rsvd.rsvd_streamed(JKEY, rstream.ArraySource(a_exp, TILE), RANK,
                                  passes=passes, method=method)
    got = rsvd.rsvd_streamed(KEY, stream.ArraySource(a_exp, TILE), RANK,
                             passes=passes, method=method, device="cpu")
    assert got.u.shape == (N, RANK) and got.vt.shape == (RANK, N)
    _svals_close(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_allclose(_err(a_exp, got), _ref_err(a_exp, want), rtol=1e-3)


def test_two_pass_equals_oneshot_rsvd_and_power_passes(a_exp):
    """passes=2 is rsvd(power_iters=0) and passes=4 rsvd(power_iters=1), up
    to f32 summation order (the reference's criterion: errors within 1e-5)."""
    a = torch.from_numpy(a_exp)
    for passes, q in ((2, 0), (4, 1)):
        streamed = rsvd.rsvd_streamed(KEY, stream.ArraySource(a_exp, TILE), RANK,
                                      passes=passes, device="cpu")
        one = rsvd.rsvd(KEY, a, RANK, power_iters=q, method="shgemm_fused",
                        device="cpu")
        assert abs(_err(a_exp, streamed) - _err(a_exp, one)) <= 1e-5
        _svals_close(streamed.s.numpy(), one.s.numpy())
    three = rsvd.rsvd_streamed(KEY, stream.ArraySource(a_exp, TILE), RANK,
                               passes=3, device="cpu")
    assert _err(a_exp, three) <= _err(a_exp, streamed) * 1.5 + 1e-6


@pytest.mark.parametrize("method,dist", [("shgemm_fused", "gaussian"),
                                         ("shgemm", "gaussian"),
                                         ("shgemm_fused", "srht")])
def test_adaptive_matches_reference(reference_draws, a_exp, method, dist):
    kw = dict(oversample=2, tol=1e-9, max_oversample=8, return_info=True,
              method=method, dist=dist)
    want, winfo = ref_rsvd.rsvd_streamed(JKEY, rstream.ArraySource(a_exp, 48),
                                         RANK, **kw)
    got, info = rsvd.rsvd_streamed(KEY, stream.ArraySource(a_exp, 48), RANK,
                                   device="cpu", **kw)
    for f in ("final_p", "widen_passes", "converged", "grown_cols",
              "grown_sketch_bytes", "full_resketch_bytes", "bound_reason"):
        assert getattr(info, f) == getattr(winfo, f), f
    assert info.final_p == RANK + 8 and info.widen_passes >= 1
    # est^2 = (||A||^2 - sum sigma^2) / ||A||^2 cancels in f32: held to ten
    # f32 epsilons, not relative to est (near 1e-3 here)
    np.testing.assert_allclose(np.square(info.est_history),
                               np.square(winfo.est_history), rtol=0,
                               atol=10 * np.finfo(np.float32).eps)
    assert [b is None for b in info.bound_history] == [b is None for b in winfo.bound_history]
    if dist == "gaussian":
        np.testing.assert_allclose(info.bound_history, winfo.bound_history, rtol=1e-3)
    _svals_close(got.s.numpy(), np.asarray(want.s))
    # the adaptive run's factorization is the fixed run's at the final width
    fresh = rsvd.rsvd_streamed(KEY, stream.ArraySource(a_exp, 48), RANK,
                               oversample=8, method=method, dist=dist, device="cpu")
    torch.testing.assert_close(got.s, fresh.s, rtol=1e-6, atol=1e-7)


def test_adaptive_widens_until_converged():
    """A tol between the starting width's error and the optimum: the fused
    lattice widens (only the new columns) until it is met.  The spectrum's
    tail (~5 %) lies well above the estimate's f32 cancellation floor."""
    s = rsvd.singular_values_exp(N, RANK, 0.05, device="cpu")
    a = rsvd.matrix_with_singular_values(torch.Generator().manual_seed(0), N, s)
    opt = float(torch.sqrt(torch.sum(s[RANK:] ** 2)) / torch.linalg.norm(s))
    start = float(rsvd.reconstruction_error(a, rsvd.rsvd_streamed(
        KEY, a, RANK, oversample=2, device="cpu")))
    tol = opt + 0.5 * (start - opt)
    res, info = rsvd.rsvd_streamed(KEY, a, RANK, oversample=2, tol=tol,
                                   max_oversample=64, return_info=True, device="cpu")
    assert info.converged and info.widen_passes >= 1
    assert info.grown_sketch_bytes < info.full_resketch_bytes
    assert info.est_history[-1] <= tol < info.est_history[0]
    assert abs(float(rsvd.reconstruction_error(a, res)) - info.est_history[-1]) <= 1e-4
    early, einfo = rsvd.rsvd_streamed(KEY, a, RANK, tol=0.5, max_oversample=32,
                                      return_info=True, device="cpu")
    assert einfo.widen_passes == 0 and einfo.converged and einfo.grown_sketch_bytes == 0


def test_rsvd_streamed_argument_checks(a_exp, tmp_path):
    src = stream.ArraySource(a_exp, TILE)
    jsrc = rstream.ArraySource(a_exp, TILE)
    for kw, match in (
            (dict(passes=0), "passes must be >= 1"),
            (dict(tol=0.0), "tol must be > 0"),
            (dict(tol=0.1, passes=3), "passes"),
            (dict(max_oversample=8), "max_oversample"),
            (dict(tol=0.1, max_oversample=-1), "max_oversample must be >= 0"),
            (dict(return_info=True), "return_info"),
            (dict(checkpoint_every_tiles=4), "checkpoint_every_tiles needs"),
            (dict(resume=True), "resume=True needs checkpoint_dir"),
            (dict(return_report=True), "return_report=True needs"),
            (dict(checkpoint_dir="ck", tol=0.1), "incompatible with adaptive"),
            (dict(n_rows=N + 1), "n_rows="),
            (dict(n_cols=N - 1), "n_cols=")):
        with pytest.raises(ValueError, match=match):
            ref_rsvd.rsvd_streamed(JKEY, jsrc, RANK, **kw)
        with pytest.raises(ValueError, match=match):
            rsvd.rsvd_streamed(KEY, src, RANK, device="cpu", **kw)
    # the checkpoint arguments run (stream.resilience): the result is the
    # plain run's bit for bit, and return_report adds the report
    plain = rsvd.rsvd_streamed(KEY, src, RANK, device="cpu")
    for i, kw in enumerate((dict(), dict(resume=True),
                            dict(return_report=True))):
        out = rsvd.rsvd_streamed(KEY, src, RANK, device="cpu",
                                 checkpoint_dir=tmp_path / str(i), **kw)
        res = out[0] if kw.get("return_report") else out
        assert all(torch.equal(x, y) for x, y in zip(res, plain)), kw
        assert list((tmp_path / str(i)).glob("ckpt_*"))
    assert out[1].attempts == 1 and out[1].goodput == 1.0
    with pytest.raises(ValueError, match="1 <= rank <= min"):
        rsvd.rsvd_streamed(KEY, src, N + 1, device="cpu")


def test_rsvd_streamed_stream_discipline(tmp_path, a_exp):
    gen = lambda: (a_exp[i:i + TILE] for i in range(0, N, TILE))
    with pytest.raises(ValueError, match="replay"):
        rsvd.rsvd_streamed(KEY, gen(), RANK, n_rows=N, n_cols=N, device="cpu")
    with pytest.raises(ValueError, match="BOTH n_rows= and n_cols="):
        rsvd.rsvd_streamed(KEY, gen, RANK, n_rows=N, device="cpu")
    with pytest.raises(ValueError, match="cover"):
        rsvd.rsvd_streamed(KEY, [a_exp[:TILE]], RANK, n_rows=N, n_cols=N,
                           device="cpu")
    one = rsvd.rsvd_streamed(KEY, gen(), RANK, n_rows=N, n_cols=N, passes=1,
                             device="cpu")
    assert one.u.shape == (N, RANK)
    np.save(tmp_path / "a.npy", a_exp)
    seen = []
    from_disk = rsvd.rsvd_streamed(KEY, stream.MemmapSource(tmp_path / "a.npy", TILE), RANK,
                                   tile_callback=lambda i, rows: seen.append((i, rows)),
                                   device="cpu")
    assert seen == [(0, 40), (1, 80), (2, 120), (3, 128)]
    in_mem = rsvd.rsvd_streamed(KEY, gen, RANK, n_rows=N, n_cols=N,
                                prefetch_depth=None, device="cpu")
    torch.testing.assert_close(from_disk.s, in_mem.s, rtol=0, atol=0)


@pytest.fixture(scope="module")
def noisy_tensor():
    dims = (16, 12, 10)
    t = np.asarray(ref_hosvd.make_test_tensor(jax.random.PRNGKey(3), dims, (6, 6, 6)))
    noise = np.random.default_rng(0).standard_normal(dims).astype(np.float32)
    return (t + 1e-2 * np.linalg.norm(t) / np.sqrt(t.size) * noise).astype(np.float32)


@pytest.mark.parametrize("method,dist", [("shgemm_fused", "gaussian"),
                                         ("shgemm", "gaussian"),
                                         ("shgemm_fused", "khatri_rao")])
def test_rp_sthosvd_streamed_matches_reference(reference_draws, noisy_tensor,
                                               method, dist):
    t, ranks = noisy_tensor, (4, 4, 4)
    want = ref_hosvd.rp_sthosvd_streamed(JKEY, rstream.ArraySource(t, 5),
                                         ranks=ranks, method=method, dist=dist)
    got = hosvd.rp_sthosvd_streamed(KEY, stream.ArraySource(t, 5), ranks=ranks,
                                    method=method, dist=dist, device="cpu")
    assert tuple(got.core.shape) == ranks
    np.testing.assert_allclose(
        float(hosvd.reconstruction_error(torch.from_numpy(t), got)),
        float(ref_hosvd.reconstruction_error(jnp.asarray(t), want)), rtol=1e-3)


def test_rp_sthosvd_streamed_adaptive_ranks_match_reference(reference_draws,
                                                            noisy_tensor):
    t = noisy_tensor
    want = ref_hosvd.rp_sthosvd_streamed(JKEY, rstream.ArraySource(t, 8), tol=5e-2,
                                         max_ranks=(8, 8, 8))
    got = hosvd.rp_sthosvd_streamed(KEY, stream.ArraySource(t, 8), tol=5e-2,
                                    max_ranks=(8, 8, 8), device="cpu")
    assert tuple(got.core.shape) == tuple(want.core.shape)
    np.testing.assert_allclose(
        float(hosvd.reconstruction_error(torch.from_numpy(t), got)),
        float(ref_hosvd.reconstruction_error(jnp.asarray(t), want)), rtol=1e-3)


def test_rp_sthosvd_streamed_argument_checks(noisy_tensor, tmp_path):
    t = noisy_tensor
    for kw, match, exc in (
            (dict(ranks=(2, 2, 2), tol=0.1), "not both", ValueError),
            (dict(tol=0.1), "needs max_ranks", ValueError),
            (dict(tol=0.0, max_ranks=(2, 2, 2)), "tol must be > 0", ValueError),
            (dict(ranks=(2, 2, 2), max_ranks=(2, 2, 2)), "max_ranks only", ValueError),
            (dict(), "missing required ranks", TypeError),
            (dict(ranks=(2, 2, 2), dims=(4, 4, 4)), "dims=", ValueError),
            (dict(ranks=(2, 2, 2), resume=True), "resume=True needs", ValueError)):
        with pytest.raises(exc, match=match):
            ref_hosvd.rp_sthosvd_streamed(JKEY, rstream.ArraySource(t, 8), **kw)
        with pytest.raises(exc, match=match):
            hosvd.rp_sthosvd_streamed(KEY, stream.ArraySource(t, 8), device="cpu", **kw)
    plain = hosvd.rp_sthosvd_streamed(KEY, stream.ArraySource(t, 8), ranks=(2, 2, 2),
                                      device="cpu")
    ckpt = hosvd.rp_sthosvd_streamed(KEY, stream.ArraySource(t, 8), ranks=(2, 2, 2),
                                     checkpoint_dir=tmp_path, device="cpu")
    assert torch.equal(ckpt.core, plain.core)
    assert all(torch.equal(x, y) for x, y in zip(ckpt.factors, plain.factors))
    assert list(tmp_path.glob("ckpt_*"))
    with pytest.raises(ValueError, match="pass dims="):
        hosvd.rp_sthosvd_streamed(KEY, iter([t]), ranks=(2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="cover"):
        hosvd.rp_sthosvd_streamed(KEY, [t[:8]], dims=t.shape, ranks=(2, 2, 2),
                                  device="cpu")
