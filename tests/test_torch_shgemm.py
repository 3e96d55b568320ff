"""Kernel 1 (kernels/shgemm.py, ops.shgemm): the port against the reference's
ops.shgemm (Pallas in interpret mode) on the same inputs, the f64-oracle
accuracy ladder and the reference's errors.  The kernel itself is held
against its plain version on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.convert import from_reference
from repro_torch.kernels import ops, ref
from repro_torch.kernels import shgemm as k1

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

REF_BLOCKS = (8, 128, 128)   # small interpret-mode blocks for the reference
SHAPES = [(37, 300, 70), (64, 256, 128), (1, 128, 1)]
LOWP = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16)}
# terms=3 is bf16-only; its error for fp16 is pinned below
LOWP_TERMS = [("bf16", 1), ("bf16", 2), ("bf16", 3), ("fp16", 1), ("fp16", 2)]


def _operands(m, k, n, jdt, seed=0):
    rng = np.random.default_rng(seed + m * 7 + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.standard_normal((k, n)), jnp.float32).astype(jdt))
    return a, b


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("lowp,terms", LOWP_TERMS)
def test_matches_reference(m, k, n, lowp, terms):
    jdt, tdt = LOWP[lowp]
    a, b = _operands(m, k, n, jdt)
    want = np.asarray(ref_ops.shgemm(jnp.asarray(a), jnp.asarray(b),
                                     blocks=REF_BLOCKS, terms=terms))
    got = ops.shgemm(torch.from_numpy(a), from_reference(b), terms=terms,
                     device="cpu")
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # same split math, different K blocking => f32 accumulation skew only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("blocks", [(32, 32, 32), (64, 64, 128), (128, 32, 256)])
def test_blocks_honoured(blocks):
    a, b = _operands(70, 300, 50, jnp.bfloat16, seed=3)
    got = ops.shgemm(torch.from_numpy(a), from_reference(b), blocks=blocks,
                     device="cpu")
    want = np.asarray(ref_ops.shgemm(jnp.asarray(a), jnp.asarray(b),
                                     blocks=REF_BLOCKS))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_shgemm_nt_matches_reference():
    a, b = _operands(40, 256, 24, jnp.bfloat16, seed=5)
    bt = np.ascontiguousarray(b.T)
    want = np.asarray(ref_ops.shgemm_nt(jnp.asarray(a), jnp.asarray(bt),
                                        blocks=REF_BLOCKS))
    got = ops.shgemm_nt(torch.from_numpy(a), from_reference(bt), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_non_lowp_b_is_cast_to_bf16():
    a, _ = _operands(16, 128, 8, jnp.bfloat16)
    b32 = np.random.default_rng(1).standard_normal((128, 8)).astype(np.float32)
    want = np.asarray(ref_ops.shgemm(jnp.asarray(a), jnp.asarray(b32),
                                     blocks=REF_BLOCKS))
    got = ops.shgemm(torch.from_numpy(a), torch.from_numpy(b32), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lowp", sorted(LOWP))
def test_accuracy_ladder(lowp):
    """1-term >> 2-term (< 1e-5) and 3-term ~ f32 against the f64 oracle
    (reference DESIGN.md §2)."""
    _, tdt = LOWP[lowp]
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((256, 512), generator=gen)
    b = torch.randn((512, 128), generator=gen).to(tdt)
    oracle = ref.sgemm_f64_oracle(a, b)

    def rel(c):
        return float(ref.relative_error_fro(c, oracle))

    e1 = rel(ops.shgemm(a, b, terms=1, device="cpu"))
    e2 = rel(ops.shgemm(a, b, terms=2, device="cpu"))
    assert e1 > 100 * e2, (e1, e2)
    assert e2 < 1e-5, e2
    if lowp == "bf16":
        e3 = rel(ops.shgemm(a, b, terms=3, device="cpu"))
        assert e3 <= 2 * rel(ref.dot_f32(a, b)), e3


def test_contraction_mismatch_raises_like_reference():
    with pytest.raises(ValueError, match="contraction mismatch"):
        ref_ops.shgemm(jnp.ones((8, 128)), jnp.ones((64, 8), jnp.bfloat16))
    with pytest.raises(ValueError, match="contraction mismatch"):
        ops.shgemm(torch.ones((8, 128)), torch.ones((64, 8), dtype=torch.bfloat16),
                   device="cpu")


def test_terms3_fp16_raises_like_reference():
    with pytest.raises(ValueError, match="terms=3 unsupported"):
        ref_ops.shgemm(jnp.ones((8, 128)), jnp.ones((128, 8), jnp.float16),
                       terms=3, blocks=REF_BLOCKS)
    with pytest.raises(ValueError, match="terms=3 unsupported"):
        ops.shgemm(torch.ones((8, 128)), torch.ones((128, 8), dtype=torch.float16),
                   terms=3, device="cpu")


def test_kernel_wrapper_checks():
    a = torch.ones((64, 64))
    b = torch.ones((64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        k1.shgemm_pallas(a[:40], b, bm=32, bn=32, bk=32)
    with pytest.raises(ValueError, match="unsupported"):
        k1.shgemm_pallas(a, b, bm=16, bn=32, bk=32)
    with pytest.raises(ValueError, match="unsupported"):
        k1.shgemm_pallas(a, b, bm=32, bn=32, bk=48)
    with pytest.raises(TypeError, match="A must be f32"):
        k1.shgemm_pallas(a.double(), b, bm=32, bn=32, bk=32)
    with pytest.raises(TypeError, match="B must be bf16/fp16"):
        k1.shgemm_pallas(a, b.float(), bm=32, bn=32, bk=32)


@pytest.mark.parametrize("m,n,k", [(4096, 266, 4096), (256, 32, 65536), (20, 3, 5)])
def test_heuristic_blocks_are_launchable(m, n, k):
    bm, bn, bk = ops.heuristic_blocks(m, n, k)
    k1.check_blocks(bm, bn, bk)
    assert bk <= max(k1.STAGE_K, -(-k // k1.STAGE_K) * k1.STAGE_K)
    assert k1.smem_bytes(bm, bn, bk) <= 48 * 1024  # static shared memory


def test_plain_is_the_reference_math():
    a, b = _operands(32, 128, 16, jnp.float16, seed=9)
    ta, tb = torch.from_numpy(a), from_reference(b)
    for terms in (1, 2):
        np.testing.assert_array_equal(k1.shgemm_plain(ta, tb, terms).numpy(),
                                      ref.shgemm_ref(ta, tb, terms).numpy())

