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
    """The planner's plan (``ops.shgemm_plan``, which replaced the
    shrink-to-fit heuristic) launches: a tile the kernel instantiates, bk
    no deeper than k rounded to the stage, a split count dividing the bk
    tiles, and dynamic shared memory within the 227 KB a block may use."""
    bm, bn, bk, splits = ops.shgemm_plan(m, n, k)
    k_pad = -(-k // bk) * bk
    k1.check_plan(-(-m // bm) * bm, -(-n // bn) * bn, k_pad, bm, bn, bk, splits)
    assert bk <= max(k1.STAGE_K, -(-k // k1.STAGE_K) * k1.STAGE_K)
    assert k1.smem_bytes(bm, bn) <= 232448  # dynamic shared memory
    assert bm * bn // 32 <= 1024  # threads: one warp per 32 x 32


# Kernel 1's planner: the main path's shapes (rSVD, RP-HOSVD and the two
# later RP-ST-HOSVD modes), then ragged ones.
PLAN_SHAPES = {"rsvd": (4096, 266, 4096), "hosvd": (256, 32, 65536),
               "sthosvd_mode1": (256, 32, 8192), "sthosvd_mode2": (256, 32, 1024),
               "ragged": (300, 130, 700), "tiny": (7, 3, 130),
               "tall": (20000, 8, 3000), "wide_k": (37, 70, 5000)}


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_shgemm_plan_is_launchable(shape):
    """bk equals kernel 2's planner's (equal bits on equal Omega); the split
    count divides the padded k's tiles, keeps the workspace under its cap
    and is the least that fills the card's waves."""
    m, n, k = PLAN_SHAPES[shape]
    bm, bn, bk, splits = ops.shgemm_plan(m, n, k)
    assert bk == ops.fused_plan(m, n, k)[2]
    m_pad, n_pad, k_pad = -(-m // bm) * bm, -(-n // bn) * bn, -(-k // bk) * bk
    k1.check_plan(m_pad, n_pad, k_pad, bm, bn, bk, splits)
    assert (k_pad // bk) % splits == 0
    assert k1.workspace_bytes(m_pad, n_pad, k_pad, bk, splits) <= ops.MAX_WORKSPACE_BYTES
    assert k1.smem_bytes(bm, bn) <= 232448
    grid = (m_pad // bm) * (n_pad // bn)
    if grid * (k_pad // bk) >= ops.SM_COUNT:
        assert grid * splits >= ops.SM_COUNT
    else:
        assert splits == k_pad // bk
    slots = ops.SM_COUNT * ops.SHGEMM_PER_SM[2]

    def fills(d):  # >= SM_COUNT blocks, all resident or WAVE_FILL of the waves
        nb = grid * d
        return nb >= ops.SM_COUNT and (
            nb <= slots or nb >= ops.WAVE_FILL * slots * -(-nb // slots))
    smaller = [d for d in range(1, splits) if (k_pad // bk) % d == 0]
    assert not any(fills(d) for d in smaller)  # the least split count that does


def test_shgemm_plan_at_the_main_path_shapes():
    """Kernel 1 takes 128 x 32 tiles, three to an SM: rSVD's 288 output
    tiles then fit the card at once without a split; RP-HOSVD's two are
    split 128 ways (256 blocks), the later RP-ST-HOSVD modes over all their
    tiles.  Three terms fit two blocks an SM: rSVD's 288 tiles would leave
    a thin second wave, so they are split 4 ways (1152 blocks, 5 waves)."""
    assert ops.shgemm_plan(*PLAN_SHAPES["rsvd"]) == (128, 32, 256, 1)
    assert ops.shgemm_plan(*PLAN_SHAPES["hosvd"]) == (128, 32, 256, 128)
    assert ops.shgemm_plan(*PLAN_SHAPES["sthosvd_mode1"]) == (128, 32, 256, 32)
    assert ops.shgemm_plan(*PLAN_SHAPES["sthosvd_mode2"]) == (128, 32, 256, 4)
    assert ops.shgemm_plan(*PLAN_SHAPES["rsvd"], terms=3) == (128, 32, 256, 4)


def test_shgemm_plan_caps_the_workspace():
    m, n, k = 8192, 32, 2**20  # 4096 tiles of a 32-block grid: 4 GiB
    assert k1.workspace_bytes(m, n, k, 256, 2) > ops.MAX_WORKSPACE_BYTES
    assert ops.shgemm_plan(m, n, k)[3] == 1
    assert ops.shgemm_plan(m, n, k // 8)[3] > 1  # 512 MiB: split


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("lowp", sorted(LOWP))
def test_ops_shgemm_with_splits_matches_reference(splits, lowp):
    """``splits=`` pins the split count; on the CPU it validates the plan
    and runs the plain version, which still matches the reference."""
    jdt, _ = LOWP[lowp]
    a, b = _operands(40, 1024, 30, jdt, seed=11)  # bk 256: four tiles
    want = np.asarray(ref_ops.shgemm(jnp.asarray(a), jnp.asarray(b),
                                     blocks=REF_BLOCKS))
    got = ops.shgemm(torch.from_numpy(a), from_reference(b), splits=splits,
                     device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw,match", [
    ({"blocks": (256, 64, 256)}, "unsupported"),
    ({"blocks": (128, 32, 48)}, "unsupported"),
    ({"splits": 3}, "must be an integer"),
    ({"splits": 0}, "must be an integer"),
    ({"splits": 8}, "must be an integer"),
    ({"splits": 2.0}, "must be an integer"),
    ({"blocks": (32, 32, 512), "splits": 4}, "must be an integer"),
])
def test_shgemm_bad_plan_raises_before_launch(kw, match, monkeypatch):
    """A bad plan raises in the wrapper's checks, before the kernel or its
    plain version runs."""
    def no_run(*args, **kwargs):
        raise AssertionError("ran despite a bad plan")
    monkeypatch.setattr(k1, "shgemm_plain", no_run)
    monkeypatch.setattr(k1, "_launcher", no_run)
    before = k1.launches
    with pytest.raises(ValueError, match=match):
        ops.shgemm(torch.ones((40, 1024)), torch.ones((1024, 30)), device="cpu", **kw)
    assert k1.launches == before


def test_plain_is_the_reference_math():
    a, b = _operands(32, 128, 16, jnp.float16, seed=9)
    ta, tb = torch.from_numpy(a), from_reference(b)
    for terms in (1, 2):
        np.testing.assert_array_equal(k1.shgemm_plain(ta, tb, terms).numpy(),
                                      ref.shgemm_ref(ta, tb, terms).numpy())

