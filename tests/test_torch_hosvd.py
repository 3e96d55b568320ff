"""core/hosvd.py and core/lstsq.py: tensor utilities, RP-HOSVD / RP-ST-HOSVD
and sketch-preconditioned least squares against the reference on the same
inputs.  The port derives per-mode keys in ``_mode_keys`` (a documented
deviation from ``jax.random.split``); here it is replaced by the words of
JAX's split, and the legacy methods' Omega by the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hosvd as ref_hosvd
from repro.core import lstsq as ref_lstsq
from repro.core import projection as ref_proj
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import hosvd, lstsq
from repro_torch.core import projection as proj

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

DIMS, RANKS = (20, 24, 28), (8, 8, 8)
METHODS = ["f32", "shgemm", "shgemm_pallas", "shgemm_fused"]


@pytest.fixture
def reference_keys(monkeypatch):
    """Per-mode keys := the words of the reference's jax.random.split, and the
    legacy Omega := the reference's jax.random Omega for those words."""
    def mode_keys(key, ndim):
        jkey = jnp.asarray(np.array(key, np.uint32))
        return [tuple(int(w) for w in np.asarray(k)) for k in jax.random.split(jkey, ndim)]

    def materialize(key, shape, *, dist="gaussian", s=None,
                    dtype=torch.bfloat16, device=None):
        jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
        omega = ref_proj.materialize_omega(jnp.asarray(np.array(key, np.uint32)),
                                           shape, dist=dist, s=s, dtype=jdt)
        return from_reference(np.asarray(omega)).to(device)
    monkeypatch.setattr(hosvd, "_mode_keys", mode_keys)
    monkeypatch.setattr(proj, "materialize_omega", materialize)


@pytest.fixture(scope="module")
def noisy_tensor():
    """Algorithm 3 tensor plus noise, so the truncation error (not f32
    rounding) sets the reconstruction error both packages are compared on."""
    t = ref_hosvd.make_test_tensor(jax.random.PRNGKey(3), DIMS, RANKS)
    noise = np.random.default_rng(0).standard_normal(DIMS).astype(np.float32)
    t = np.asarray(t)
    return (t + 1e-2 * np.linalg.norm(t) / np.sqrt(t.size) * noise).astype(np.float32)


def test_unfold_fold_match_reference():
    t = np.random.default_rng(1).standard_normal((5, 7, 11, 3)).astype(np.float32)
    for mode in range(4):
        want = np.asarray(ref_hosvd.unfold(jnp.asarray(t), mode))
        got = hosvd.unfold(torch.from_numpy(t), mode)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(hosvd.fold(got, mode, t.shape).numpy(), t)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mode_dot_matches_reference(mode):
    rng = np.random.default_rng(2)
    t = rng.standard_normal((6, 8, 10)).astype(np.float32)
    m = rng.standard_normal((4, t.shape[mode])).astype(np.float32)
    want = np.asarray(ref_hosvd.mode_dot(jnp.asarray(t), jnp.asarray(m), mode))
    got = hosvd.mode_dot(torch.from_numpy(t), torch.from_numpy(m), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("algo", ["rp_hosvd", "rp_sthosvd"])
@pytest.mark.parametrize("method", METHODS)
def test_rp_hosvd_matches_reference(reference_keys, noisy_tensor, algo, method):
    t = noisy_tensor
    want = getattr(ref_hosvd, algo)(jax.random.PRNGKey(4), jnp.asarray(t),
                                    RANKS, method=method)
    got = getattr(hosvd, algo)(key_from_seed(4), torch.from_numpy(t), RANKS,
                               method=method, device="cpu")
    assert tuple(got.core.shape) == RANKS
    assert [tuple(q.shape) for q in got.factors] == [(d, r) for d, r in zip(DIMS, RANKS)]
    np.testing.assert_allclose(
        float(hosvd.reconstruction_error(torch.from_numpy(t), got)),
        float(ref_hosvd.reconstruction_error(jnp.asarray(t), want)), rtol=1e-3)
    np.testing.assert_allclose(float(torch.linalg.norm(got.core)),
                               float(jnp.linalg.norm(want.core)), rtol=1e-3)


def test_mode_keys_are_distinct_and_deterministic():
    keys = hosvd._mode_keys(key_from_seed(4), 3)
    assert len(set(keys)) == 3 and keys == hosvd._mode_keys((0, 4), 3)
    assert all(0 <= w < 2**32 for k in keys for w in k)
    assert keys != hosvd._mode_keys(key_from_seed(5), 3)


@pytest.mark.parametrize("tol", [1e-1, 3e-2])
def test_truncate_tucker_picks_reference_ranks(noisy_tensor, tol):
    res = ref_hosvd.rp_hosvd(jax.random.PRNGKey(6), jnp.asarray(noisy_tensor),
                             RANKS, method="f32")
    want = ref_hosvd.truncate_tucker(res, tol)
    got = hosvd.truncate_tucker(hosvd.TuckerResult(
        from_reference(np.asarray(res.core)),
        tuple(from_reference(np.asarray(q)) for q in res.factors)), tol)
    assert tuple(got.core.shape) == tuple(want.core.shape)
    np.testing.assert_allclose(
        float(hosvd.reconstruction_error(torch.from_numpy(noisy_tensor), got)),
        float(ref_hosvd.reconstruction_error(jnp.asarray(noisy_tensor), want)),
        rtol=1e-3)


def test_truncate_tucker_rejects_bad_tol():
    res = hosvd.TuckerResult(torch.ones((2, 2)), (torch.eye(2), torch.eye(2)))
    with pytest.raises(ValueError, match="tol must be > 0"):
        hosvd.truncate_tucker(res, 0.0)


def test_make_test_tensor_has_the_padded_multilinear_rank():
    t = hosvd.make_test_tensor(torch.Generator().manual_seed(0), DIMS, RANKS, pad=2)
    assert tuple(t.shape) == DIMS
    for mode in range(3):
        s = torch.linalg.svdvals(hosvd.unfold(t, mode))
        assert float(s[RANKS[mode] - 2 - 1]) > 1e-3 * float(s[0])
        assert float(s[RANKS[mode] - 2]) < 1e-5 * float(s[0])


def test_khatri_rao_not_ported_yet(reference_keys, noisy_tensor):
    """Khatri-Rao is ported (core/structured.py): RP-HOSVD through the
    factor-by-factor mode sketches matches the reference."""
    t = noisy_tensor
    want = ref_hosvd.rp_hosvd(jax.random.PRNGKey(4), jnp.asarray(t), RANKS,
                              dist="khatri_rao")
    got = hosvd.rp_hosvd(key_from_seed(4), torch.from_numpy(t), RANKS,
                         dist="khatri_rao", device="cpu")
    np.testing.assert_allclose(
        float(hosvd.reconstruction_error(torch.from_numpy(t), got)),
        float(ref_hosvd.reconstruction_error(jnp.asarray(t), want)), rtol=1e-3)


@pytest.mark.parametrize("method", ["shgemm", "shgemm_fused"])
def test_lstsq_matches_reference(reference_keys, method):
    key = jax.random.PRNGKey(9)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (512, 32))
    b = a @ jax.random.normal(k2, (32,)) + 1e-3 * jax.random.normal(k3, (512,))
    want = ref_lstsq.sketch_precond_lstsq(jax.random.PRNGKey(10), a, b,
                                          method=method)
    got = lstsq.sketch_precond_lstsq(key_from_seed(10), from_reference(np.asarray(a)),
                                     from_reference(np.asarray(b)), method=method,
                                     device="cpu")
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-3)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-3, atol=1e-4)
    assert got.iters == int(want.iters)
