"""core/projection.py: the port's ``project`` against the reference for all
six methods on the same Omega (materialized in JAX and carried across with
convert.from_reference), ``sketch(method="shgemm_fused")`` against the
reference with the same key, and the port's documented Omega deviation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as ref_proj
from repro.kernels import shgemm_fused as ref_kf
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import projection as proj

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

METHODS = ["f32", "lowp_single", "shgemm", "shgemm3", "shgemm_pallas",
           "shgemm_fused"]
OMEGA_DTYPES = {"bf16": jnp.bfloat16, "fp16": jnp.float16,
                "e4m3": jnp.float8_e4m3fn}


def _a(m=48, k=256, seed=0):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("omega_dtype", sorted(OMEGA_DTYPES))
def test_project_matches_reference(method, omega_dtype):
    a = _a()
    omega = np.asarray(ref_proj.gaussian(jax.random.PRNGKey(1), (256, 40),
                                         dtype=OMEGA_DTYPES[omega_dtype]))
    want = np.asarray(ref_proj.project(jnp.asarray(a), jnp.asarray(omega),
                                       method=method))
    got = proj.project(torch.from_numpy(a), from_reference(omega),
                       method=method, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_shgemm_jnp_matches_reference():
    a = _a(seed=2)
    omega = np.asarray(ref_proj.gaussian(jax.random.PRNGKey(2), (256, 16),
                                         dtype=jnp.float16))
    want = np.asarray(ref_proj.shgemm_jnp(jnp.asarray(a), jnp.asarray(omega)))
    got = proj.shgemm_jnp(torch.from_numpy(a), from_reference(omega))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dist", ["gaussian", "achlioptas", "very_sparse"])
def test_sketch_fused_matches_reference(dist):
    """Same seed -> same key words -> same Omega lattice in both packages."""
    if dist == "gaussian":
        a = _a(seed=3)
    else:  # exact sums: bitwise regardless of summation order
        a = np.random.default_rng(3).integers(-2**14, 2**14, (48, 256)).astype(np.float32)
    want = np.asarray(ref_proj.sketch(jax.random.PRNGKey(5), jnp.asarray(a), 24,
                                      method="shgemm_fused", dist=dist))
    got = proj.sketch(key_from_seed(5), torch.from_numpy(a), 24,
                      method="shgemm_fused", dist=dist, device="cpu").numpy()
    if dist != "gaussian":
        np.testing.assert_array_equal(got, want)
        return
    gap = np.abs(proj.fused_omega(key_from_seed(5), (256, 24), device="cpu")
                 .float().numpy().astype(np.float64)
                 - np.asarray(ref_proj.fused_omega(jax.random.PRNGKey(5), (256, 24))
                              .astype(jnp.float32)))
    allowance = np.abs(a.astype(np.float64)) @ gap
    np.testing.assert_array_less(np.abs(got - want) - allowance,
                                 1e-4 + 1e-5 * np.abs(want))


@pytest.mark.parametrize("dist", ["gaussian", "achlioptas", "very_sparse"])
def test_materialize_omega_is_the_counter_lattice(dist):
    """Documented deviation: every dist comes from the fused lattice, so the
    legacy and fused Omegas coincide."""
    key = key_from_seed(11)
    np.testing.assert_array_equal(
        proj.materialize_omega(key, (128, 20), dist=dist, device="cpu").float().numpy(),
        proj.fused_omega(key, (128, 20), dist=dist, device="cpu").float().numpy())


@pytest.mark.parametrize("name,dist,kw", [
    ("gaussian", "gaussian", {}),
    ("achlioptas_sparse", "achlioptas", {"s": 4.0}),
    ("very_sparse", "very_sparse", {}),
])
def test_generators_match_reference_lattice(name, dist, kw):
    got = getattr(proj, name)(key_from_seed(9), (200, 30), dtype=torch.float32,
                              device="cpu", **kw)
    want = np.asarray(ref_kf.reference_omega(jax.random.PRNGKey(9), (200, 30),
                                             dist=dist, s=kw.get("s")))
    if dist == "gaussian":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["shgemm", "shgemm_fused"])
def test_srht_not_ported_yet(method):
    """SRHT is ported (core/structured.py): the sketch matches the
    reference's whatever the method, and the dense Omega is its oracle."""
    a = _a(8, 16)
    got = proj.sketch(key_from_seed(0), torch.from_numpy(a), 4, method=method,
                      dist="srht", device="cpu")
    want = np.asarray(ref_proj.sketch(jax.random.PRNGKey(0), jnp.asarray(a), 4,
                                      method=method, dist="srht"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    omega = proj.materialize_omega(key_from_seed(0), (16, 4), dist="srht",
                                   device="cpu")
    np.testing.assert_array_equal(
        omega.float().numpy(),
        np.asarray(ref_proj.materialize_omega(jax.random.PRNGKey(0), (16, 4),
                                              dist="srht"), np.float32))


def test_unknown_method_and_dist_raise():
    with pytest.raises(ValueError, match="unknown projection method"):
        proj.project(torch.ones((4, 4)), torch.ones((4, 2)), method="tf32",
                     device="cpu")
    with pytest.raises(ValueError, match="unknown sketch distribution"):
        proj.materialize_omega(key_from_seed(0), (4, 2), dist="cauchy",
                               device="cpu")
