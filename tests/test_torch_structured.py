"""core/structured.py against the reference on the same inputs: the FWHT,
the SRHT counter streams and dense oracle (bitwise), the O(n log n) SRHT
apply (1e-5 relative, and no GEMM in its operator trace), the Khatri-Rao
factors and factor-by-factor mode sketches, the estimator-validity table,
``gaussian_fp8`` and the structured dists wired through ``projection`` and
``hosvd``.  The Gaussian lattice values pass through log and cos, which
differ between XLA and PyTorch by an ulp here and there, so they are held to
f32 rounding; the uint32 words and the sign/index streams are bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import hosvd as ref_hosvd
from repro.core import projection as ref_proj
from repro.core import structured as ref_sx
from repro.kernels import shgemm_fused as ref_kf
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import hosvd, projection as proj, structured as sx

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

SEED = 1234
KEY = key_from_seed(SEED)
JKEY = jax.random.PRNGKey(SEED)
GEMM_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm",
            "aten::baddbmm", "aten::dot", "aten::mv", "aten::linear",
            "aten::einsum", "aten::tensordot")


def _rel(y, ref):
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(y - ref) / max(np.linalg.norm(ref), 1e-30))


def _a(m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


def test_next_pow2_and_popcount():
    for n in (1, 2, 3, 64, 65, 100, 4096, 4097):
        assert sx.next_pow2(n) == ref_sx.next_pow2(n)
    with pytest.raises(ValueError, match="n >= 1"):
        sx.next_pow2(0)
    x = torch.tensor([0, 1, 3, 255, 2**31, 2**32 - 1, 0x55AA55AA], dtype=torch.int64)
    assert sx.popcount(x).tolist() == [bin(v).count("1") for v in x.tolist()]


@pytest.mark.parametrize("shape", [(3, 64), (2, 4, 16), (1, 1)])
def test_fwht_matches_reference(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = sx.fwht(torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(ref_sx.fwht(jnp.asarray(x)))) <= 1e-5
    L = shape[-1]
    idx = np.arange(L)
    h = 1 - 2 * (np.vectorize(lambda v: bin(v).count("1"))(idx[:, None] & idx[None, :]) % 2)
    assert _rel(got, x @ h.T) <= 1e-5
    with pytest.raises(ValueError, match="power of two"):
        sx.fwht(torch.ones((2, 12)))


def test_srht_streams_bitwise():
    rows = np.arange(300, dtype=np.int32) + 4096
    want_d = np.asarray(ref_sx.srht_signs(JKEY, jnp.asarray(rows)))
    got_d = sx.srht_signs(KEY, torch.from_numpy(rows.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    for L in (1, 64, 4096):
        cols = np.arange(200, dtype=np.int32) + 7
        want = np.asarray(ref_sx.srht_col_indices(JKEY, jnp.asarray(cols), L))
        got = sx.srht_col_indices(KEY, torch.from_numpy(cols.astype(np.int64)), L)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(shape=(64, 12)),
    dict(shape=(100, 9), p_total=20, col_offset=11),
    dict(shape=(40, 12), n_total=300, row_offset=256),
], ids=["plain", "cols", "rows"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_srht_omega_bitwise(kw, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(kw)
    shape = kw.pop("shape")
    want = np.asarray(ref_sx.srht_omega(JKEY, shape, dtype=jdt, **kw))
    got = sx.srht_omega(KEY, shape, dtype=tdt, device="cpu", **kw)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("m,n,p", [(20, 64, 12), (17, 100, 9), (8, 256, 33)])
def test_srht_sketch_matches_reference_and_oracle(m, n, p):
    a = _a(m, n)
    want = np.asarray(ref_sx.srht_sketch(JKEY, jnp.asarray(a), p))
    got = sx.srht_sketch(KEY, torch.from_numpy(a), p, device="cpu")
    assert tuple(got.shape) == (m, p)
    assert _rel(got.numpy(), want) <= 1e-5
    oracle = a @ sx.srht_omega(KEY, (n, p), device="cpu").numpy()
    assert _rel(got.numpy(), oracle) <= 1e-5
    assert sx.srht_apply_flops(m, n, p) == ref_sx.srht_apply_flops(m, n, p)
    assert sx.srht_apply_flops(m, n, p) < 2 * m * n * p or n < 64


def test_srht_sketch_runs_no_gemm():
    """The reference asserts no dot_general in the jaxpr; here no GEMM
    operator is dispatched at all during the apply."""
    a = torch.from_numpy(_a(32, 200))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proj.sketch(KEY, a, 16, dist="srht", method="shgemm", device="cpu")
    names = {ev.key for ev in prof.key_averages()}
    assert "aten::index_select" in names, sorted(names)
    assert not names & set(GEMM_OPS), sorted(names & set(GEMM_OPS))


@pytest.mark.parametrize("method", ["f32", "shgemm", "shgemm_pallas", "shgemm_fused"])
def test_sketch_srht_ignores_method(method):
    a = _a(24, 80)
    got = proj.sketch(KEY, torch.from_numpy(a), 10, dist="srht", method=method,
                      device="cpu")
    torch.testing.assert_close(got, sx.srht_sketch(KEY, torch.from_numpy(a), 10,
                                                   device="cpu"), rtol=0, atol=0)
    want = np.asarray(ref_proj.sketch(JKEY, jnp.asarray(a), 10, dist="srht",
                                      method=method))
    assert _rel(got.numpy(), want) <= 1e-5


def test_khatri_rao_factor_words_and_rows():
    kro = sx.KhatriRaoOmega(key=KEY, dims=(6, 5, 4), mode=1, p=3, device="cpu")
    ref = ref_sx.KhatriRaoOmega(key=JKEY, dims=(6, 5, 4), mode=1, p=3)
    for j in (0, 2, 7):
        assert kro._factor_words(j) == tuple(int(w) for w in np.asarray(ref._factor_words(j)))
    for j in (0, 2):
        np.testing.assert_allclose(kro.factor(j).numpy(), np.asarray(ref.factor(j)),
                                   rtol=1e-6, atol=1e-6)
    # rows regenerated at an offset are the full factor's rows, bitwise
    full = kro.factor(0)
    torch.testing.assert_close(kro.factor(0, rows=3, row_offset=2), full[2:5],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="sketched mode"):
        kro.factor(1)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_khatri_rao_sketch_slab_matches_reference(mode):
    dims = (6, 5, 4)
    t = np.random.default_rng(mode).standard_normal(dims).astype(np.float32)
    kro = sx.KhatriRaoOmega(key=KEY, dims=dims, mode=mode, p=3, device="cpu")
    ref = ref_sx.KhatriRaoOmega(key=JKEY, dims=dims, mode=mode, p=3)
    got = kro.sketch_slab(torch.from_numpy(t))
    assert _rel(got.numpy(), np.asarray(ref.sketch_slab(jnp.asarray(t)))) <= 1e-5
    oracle = hosvd.unfold(torch.from_numpy(t), mode).numpy() @ kro.dense().numpy()
    assert _rel(got.numpy(), oracle) <= 1e-5
    assert _rel(kro.dense().numpy(), np.asarray(ref.dense())) <= 1e-6


def test_khatri_rao_slab_accumulation():
    dims = (8, 5, 4)
    t = torch.from_numpy(np.random.default_rng(3).standard_normal(dims).astype(np.float32))
    for mode in (1, 2):
        kro = sx.KhatriRaoOmega(key=KEY, dims=dims, mode=mode, p=3, device="cpu")
        full = kro.sketch_slab(t)
        parts = sum(kro.sketch_slab(t[i:i + 3], axis0_offset=i) for i in (0, 3, 6))
        torch.testing.assert_close(parts, full, rtol=1e-5, atol=1e-5)
    kro0 = sx.KhatriRaoOmega(key=KEY, dims=dims, mode=0, p=3, device="cpu")
    torch.testing.assert_close(kro0.sketch_slab(t[3:6]), kro0.sketch_slab(t)[3:6],
                               rtol=1e-5, atol=1e-6)


def test_khatri_rao_validation_like_reference():
    for mod, key in ((sx, KEY), (ref_sx, JKEY)):
        with pytest.raises(ValueError, match="out of range"):
            mod.KhatriRaoOmega(key=key, dims=(6, 5), mode=2, p=3)
        with pytest.raises(ValueError, match="ndim >= 2"):
            mod.KhatriRaoOmega(key=key, dims=(6,), mode=0, p=3)
    kro = sx.KhatriRaoOmega(key=KEY, dims=(6, 5, 4), mode=0, p=3, device="cpu")
    with pytest.raises(ValueError, match="slabs tile axis 0"):
        kro.sketch_slab(torch.zeros((6, 5, 3)))
    with pytest.raises(ValueError, match="ndim"):
        kro.sketch_slab(torch.zeros((6, 5)))


def test_record_shapes_never_sees_the_unfolding():
    dims = (12, 6, 5, 4)
    t = torch.from_numpy(np.random.default_rng(4).standard_normal(dims).astype(np.float32))
    with sx.record_shapes() as shapes:
        hosvd.rp_sthosvd(KEY, t, (3, 3, 3, 3), dist="khatri_rao", device="cpu")
    assert shapes
    min_unfold = min(int(np.prod([d for j, d in enumerate(dims) if j != i]))
                     for i in range(len(dims)))
    assert max(int(np.prod(s[1:])) for s in shapes) < min_unfold
    assert sx._SHAPE_LOG is None


def test_estimator_validity_equals_reference():
    assert sx.ESTIMATOR_VALIDITY == ref_sx.ESTIMATOR_VALIDITY
    for d in sx.ESTIMATOR_VALIDITY:
        assert sx.halko_bound_valid(d) == ref_sx.halko_bound_valid(d)
        assert sx.bound_invalid_reason(d) == ref_sx.bound_invalid_reason(d)
    with pytest.raises(ValueError, match="unknown sketch distribution"):
        sx.halko_bound_valid("cauchy")


@pytest.mark.parametrize("variant", ["e4m3", "e5m2"])
def test_gaussian_fp8_bits(variant):
    """fp8 storage of the lattice Gaussian: the port's bits equal the
    reference's fp8 rounding of the same lattice (the port's documented Omega
    deviation), and the f32 -> fp8 rounding is bitwise on shared values."""
    jdt = jnp.float8_e4m3fn if variant == "e4m3" else jnp.float8_e5m2
    got = proj.gaussian_fp8(KEY, (64, 16), variant=variant, device="cpu")
    assert got.dtype == (torch.float8_e4m3fn if variant == "e4m3" else torch.float8_e5m2)
    want = from_reference(np.asarray(ref_kf.reference_omega(JKEY, (64, 16), dtype=jdt)))
    torch.testing.assert_close(got.view(torch.uint8), want.view(torch.uint8),
                               rtol=0, atol=0)
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32) * 30
    torch.testing.assert_close(
        torch.from_numpy(x).to(got.dtype).view(torch.uint8),
        from_reference(np.asarray(jnp.asarray(x).astype(jdt))).view(torch.uint8),
        rtol=0, atol=0)
    # storage only: project consumes it as bf16
    a = torch.from_numpy(_a(8, 64))
    torch.testing.assert_close(proj.project(a, got, method="f32", device="cpu"),
                               a @ got.to(torch.bfloat16).float(), rtol=1e-6, atol=1e-6)


def test_materialize_omega_srht_is_the_oracle():
    got = proj.materialize_omega(KEY, (48, 8), dist="srht", dtype=torch.float32,
                                 device="cpu")
    want = np.asarray(ref_proj.materialize_omega(JKEY, (48, 8), dist="srht",
                                                 dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def reference_mode_keys(monkeypatch):
    """Per-mode keys := the words of the reference's jax.random.split (the
    port's ``_mode_keys`` is a documented deviation)."""
    def mode_keys(key, ndim):
        jkey = jnp.asarray(np.array(key, np.uint32))
        return [tuple(int(w) for w in np.asarray(k)) for k in jax.random.split(jkey, ndim)]
    monkeypatch.setattr(hosvd, "_mode_keys", mode_keys)


@pytest.mark.parametrize("algo", ["rp_hosvd", "rp_sthosvd"])
def test_khatri_rao_hosvd_matches_reference(reference_mode_keys, algo):
    dims, ranks = (12, 10, 8), (4, 4, 4)
    t = np.asarray(ref_hosvd.make_test_tensor(jax.random.PRNGKey(3), dims, (6, 6, 6)))
    t = t + 1e-2 * np.linalg.norm(t) / np.sqrt(t.size) * \
        np.random.default_rng(0).standard_normal(dims).astype(np.float32)
    t = t.astype(np.float32)
    want = getattr(ref_hosvd, algo)(jax.random.PRNGKey(4), jnp.asarray(t), ranks,
                                    dist="khatri_rao")
    got = getattr(hosvd, algo)(key_from_seed(4), torch.from_numpy(t), ranks,
                               dist="khatri_rao", device="cpu")
    assert tuple(got.core.shape) == ranks
    np.testing.assert_allclose(
        float(hosvd.reconstruction_error(torch.from_numpy(t), got)),
        float(ref_hosvd.reconstruction_error(jnp.asarray(t), want)), rtol=1e-3)
