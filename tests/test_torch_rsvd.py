"""core/rsvd.py: the port's rsvd / range_finder / nystrom_eigh against the
reference on the same matrix and the same Omega.  For ``shgemm_fused`` the
same key gives the same Omega in both packages; for the other methods the
port's ``materialize_omega`` is replaced by the reference's jax.random Omega.
Factor signs are ambiguous, so singular values, reconstruction and
projection errors are compared, not U and V."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as ref_proj
from repro.core import rsvd as ref_rsvd
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import projection as proj
from repro_torch.core import rsvd

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

N, RANK, OS = 160, 20, 10
SEED = 1
METHODS = ["f32", "lowp_single", "shgemm", "shgemm3", "shgemm_pallas",
           "shgemm_fused"]


@pytest.fixture(scope="module")
def a_exp():
    s = ref_rsvd.singular_values_exp(N, RANK, 1e-3)
    return np.array(ref_rsvd.matrix_with_singular_values(
        jax.random.PRNGKey(0), N, s))


@pytest.fixture
def reference_omega(monkeypatch):
    """The port's legacy Omega := the reference's jax.random Omega for the
    same key words."""
    def materialize(key, shape, *, dist="gaussian", s=None,
                    dtype=torch.bfloat16, device=None):
        jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
               torch.float32: jnp.float32}[dtype]
        jkey = jnp.asarray(np.array(key, np.uint32))
        omega = ref_proj.materialize_omega(jkey, shape, dist=dist, s=s, dtype=jdt)
        return from_reference(np.asarray(omega)).to(device)
    monkeypatch.setattr(proj, "materialize_omega", materialize)


def _svals_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want[0])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("power_iters", [0, 2])
def test_rsvd_matches_reference(a_exp, reference_omega, method, power_iters):
    want = ref_rsvd.rsvd(jax.random.PRNGKey(SEED), jnp.asarray(a_exp), RANK,
                         oversample=OS, power_iters=power_iters, method=method)
    got = rsvd.rsvd(key_from_seed(SEED), torch.from_numpy(a_exp), RANK,
                    oversample=OS, power_iters=power_iters, method=method,
                    device="cpu")
    assert got.u.shape == (N, RANK) and got.vt.shape == (RANK, N)
    _svals_close(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_allclose(
        float(rsvd.reconstruction_error(torch.from_numpy(a_exp), got)),
        float(ref_rsvd.reconstruction_error(jnp.asarray(a_exp), want)), rtol=1e-3)


@pytest.mark.parametrize("method", ["f32", "shgemm", "shgemm_fused"])
def test_range_finder_matches_reference(a_exp, reference_omega, method):
    want = ref_rsvd.range_finder(jax.random.PRNGKey(SEED), jnp.asarray(a_exp),
                                 RANK, method=method)
    got = rsvd.range_finder(key_from_seed(SEED), torch.from_numpy(a_exp), RANK,
                            method=method, device="cpu")
    np.testing.assert_allclose(
        float(rsvd.projection_error(torch.from_numpy(a_exp), got)),
        float(ref_rsvd.projection_error(jnp.asarray(a_exp), want)), rtol=1e-3)


@pytest.mark.parametrize("method", ["f32", "shgemm", "shgemm_fused"])
def test_nystrom_matches_reference(reference_omega, method):
    s = np.asarray(ref_rsvd.singular_values_exp(N, RANK, 1e-3))
    u = np.linalg.qr(np.random.default_rng(4).standard_normal((N, N)))[0]
    psd = ((u * s) @ u.T).astype(np.float32)
    want_u, want_lam = ref_rsvd.nystrom_eigh(jax.random.PRNGKey(SEED),
                                             jnp.asarray(psd), RANK, method=method)
    got_u, got_lam = rsvd.nystrom_eigh(key_from_seed(SEED), torch.from_numpy(psd),
                                       RANK, method=method, device="cpu")
    _svals_close(got_lam.numpy(), np.asarray(want_lam))
    # the captured subspaces agree: |U_got^T U_want| has singular values ~1
    overlap = np.linalg.svd(got_u.numpy().T @ np.asarray(want_u), compute_uv=False)
    assert overlap.min() > 1 - 1e-3


def test_check_rank_raises_like_reference():
    for rank in (0, 41):
        with pytest.raises(ValueError, match="out of range"):
            ref_rsvd._check_rank(rank, 40, 50)
        with pytest.raises(ValueError, match="out of range"):
            rsvd._check_rank(rank, 40, 50)
        with pytest.raises(ValueError, match="out of range"):
            rsvd.rsvd(key_from_seed(0), torch.ones((40, 50)), rank, device="cpu")
    rsvd._check_rank(40, 40, 50)


@pytest.mark.parametrize("oversample", [1, 0, -3])
def test_halko_bound_domain_like_reference(oversample):
    with pytest.raises(ValueError, match="oversample >= 2"):
        ref_rsvd.halko_bound(1.0, RANK, oversample)
    with pytest.raises(ValueError, match="oversample >= 2"):
        rsvd.halko_bound(1.0, RANK, oversample)


def test_halko_bound_value():
    np.testing.assert_allclose(float(rsvd.halko_bound(torch.tensor(2.0), 20, 10)),
                               float(ref_rsvd.halko_bound(2.0, 20, 10)), rtol=1e-6)


@pytest.mark.parametrize("name", ["singular_values_exp", "singular_values_linear"])
def test_spectra_match_reference(name):
    want = np.asarray(getattr(ref_rsvd, name)(300, 24, 1e-4))
    got = getattr(rsvd, name)(300, 24, 1e-4, device="cpu").numpy()
    # XLA evaluates exp2(x) as exp(x ln 2), whose error grows with |x|, and
    # flushes the subnormal tail to zero
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=np.finfo(np.float32).tiny)


def test_builders_on_a_generator():
    gen = torch.Generator().manual_seed(0)
    s = rsvd.singular_values_exp(64, 8, 1e-3, device="cpu")
    a = rsvd.matrix_with_singular_values(gen, 64, s)
    np.testing.assert_allclose(torch.linalg.svdvals(a).numpy(), s.numpy(),
                               rtol=1e-4, atol=1e-6)
    t1 = rsvd.matrix_type1(gen, 64, r=4)
    np.testing.assert_allclose(t1.numpy(), t1.T.numpy(), atol=1e-6)
    t2 = rsvd.matrix_type2(gen, 64, r=4)
    np.testing.assert_allclose(torch.linalg.svdvals(t2)[:4].numpy(), 1e6, rtol=1e-4)
    c = rsvd.matrix_cauchy(gen, 64)
    assert c.shape == (64, 64) and float(c.max()) <= 1000.0 and float(c.min()) > 0
    again = rsvd.matrix_with_singular_values(torch.Generator().manual_seed(0), 64, s)
    np.testing.assert_array_equal(a.numpy(), again.numpy())
