"""Kernel 2 (kernels/shgemm_fused.py, ops.shgemm_fused): the host-side
counter lattice against the reference bit for bit, the port's
ops.shgemm_fused against the reference's (Pallas in interpret mode) and the
reference's errors.  The kernel itself is held against its plain version on
the card in tests/test_torch_cuda.py.

Bitwise where the reference's contract is backend-free: counter bits and the
sign distributions' values.  The Gaussian goes through log and cos, which
XLA and PyTorch evaluate to within an ulp or two (reference DESIGN.md §9
item 2), so its samples agree to a tolerance and a rare sample rounds to a
neighbouring bf16/fp16 value; the products allow for exactly those."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import shgemm_fused as ref_kf
from repro_torch.convert import key_from_seed, key_words_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm as k1
from repro_torch.kernels import shgemm_fused as kf

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

SEED = 42
JKEY = jax.random.PRNGKey(SEED)
KEY = key_from_seed(SEED)
REF_BLOCKS = (8, 128, 128)
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16),
          "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
OFFSETS = [(0, 0), (256, 5)]
NEAR_2_31 = 2**31 - 64


def test_key_from_seed_is_the_reference_key_words():
    for seed in (0, 1, 42, 2**32 - 1):
        words = np.asarray(ref_kf.key_words(jax.random.PRNGKey(seed)))
        assert key_from_seed(seed) == key_words_from_numpy(words)
        assert key_words_from_numpy(words) == tuple(int(w) for w in words[0])


@pytest.mark.parametrize("stream", [0, 1, 6])
def test_counter_bits_bitwise(stream):
    rng = np.random.default_rng(stream)
    rows = np.concatenate([rng.integers(0, 2**31 - 1, 3000),
                           NEAR_2_31 + np.arange(64)]).astype(np.int32)
    cols = np.concatenate([rng.integers(0, 2**31 - 1, 3000),
                           2**31 - 1 - np.arange(64)]).astype(np.int32)
    k0, k1 = 0x12345678, 0xDEADBEEF
    want = np.asarray(ref_kf.counter_bits(jnp.uint32(k0), jnp.uint32(k1),
                                          jnp.asarray(rows), jnp.asarray(cols),
                                          stream))
    got = kf.counter_bits(k0, k1, torch.from_numpy(rows.astype(np.int64)),
                          torch.from_numpy(cols.astype(np.int64)), stream)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dist,s", [("achlioptas", None), ("achlioptas", 5.0),
                                    ("very_sparse", None), ("very_sparse", 7.5)])
@pytest.mark.parametrize("offsets", [(0, 0), (384, 17), (NEAR_2_31, NEAR_2_31)])
def test_reference_omega_sign_dists_bitwise(dist, s, offsets):
    shape = (300, 70)
    want = np.asarray(ref_kf.reference_omega(JKEY, shape, dist=dist, s=s,
                                             row_offset=offsets[0],
                                             col_offset=offsets[1]))
    got = kf.reference_omega(KEY, shape, dist=dist, s=s, row_offset=offsets[0],
                             col_offset=offsets[1], device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offsets", [(0, 0), (384, 17), (NEAR_2_31, NEAR_2_31)])
def test_reference_omega_gaussian(offsets):
    shape = (300, 70)
    want = np.asarray(ref_kf.reference_omega(JKEY, shape, row_offset=offsets[0],
                                             col_offset=offsets[1]))
    got = kf.reference_omega(KEY, shape, row_offset=offsets[0],
                             col_offset=offsets[1], device="cpu").numpy()
    # log/cos to within a few f32 ulps of samples bounded by ~5.9
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_reference_omega_offsets_slice_the_lattice():
    big = kf.reference_omega(KEY, (200, 90), dist="achlioptas", device="cpu")
    part = kf.reference_omega(KEY, (72, 40), dist="achlioptas", row_offset=128,
                              col_offset=50, device="cpu")
    np.testing.assert_array_equal(part.numpy(), big[128:, 50:].numpy())


def _lowp_omega_gap(jdt, tdt, dist, k, n, s, offsets):
    """|Omega_port - Omega_ref| after rounding to the storage type (zero for
    the sign dists; a rare one-ulp step for the Gaussian)."""
    want = np.asarray(ref_kf.reference_omega(
        JKEY, (k, n), dist=dist, s=s, row_offset=offsets[0],
        col_offset=offsets[1]).astype(jdt).astype(jnp.float32))
    got = kf.reference_omega(KEY, (k, n), dist=dist, s=s, dtype=tdt,
                             row_offset=offsets[0], col_offset=offsets[1],
                             device="cpu").float().numpy()
    return np.abs(got.astype(np.float64) - want)


@pytest.mark.parametrize("dist", ["gaussian", "achlioptas", "very_sparse"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("offsets", OFFSETS)
def test_ops_shgemm_fused_matches_reference(dist, dtype, offsets):
    jdt, tdt = DTYPES[dtype]
    m, k, n = 40, 256, 30
    rng = np.random.default_rng(7)
    if dist == "gaussian":
        a = rng.standard_normal((m, k)).astype(np.float32)
    else:
        # integer-valued A: every split term, product and partial sum is
        # exact in f32, so any summation order gives the same bits
        a = rng.integers(-2**14, 2**14, (m, k)).astype(np.float32)
    want = np.asarray(ref_ops.shgemm_fused(
        jnp.asarray(a), JKEY, n, dist=dist, omega_dtype=jdt, blocks=REF_BLOCKS,
        row_offset=offsets[0], col_offset=offsets[1]))
    got = ops.shgemm_fused(torch.from_numpy(a), KEY, n, dist=dist,
                           omega_dtype=tdt, row_offset=offsets[0],
                           col_offset=offsets[1], device="cpu").numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    if dist != "gaussian":
        np.testing.assert_array_equal(got, want)
        return
    gap = _lowp_omega_gap(jdt, tdt, dist, k, n, None, offsets)
    assert (gap > 0).mean() < 1e-3  # only rounding-boundary samples differ
    allowance = np.abs(a.astype(np.float64)) @ gap
    np.testing.assert_array_less(np.abs(got - want) - allowance,
                                 1e-4 + 1e-5 * np.abs(want))


def test_explicit_s_and_terms_match_reference():
    a = np.random.default_rng(8).integers(-2**14, 2**14, (24, 200)).astype(np.float32)
    for terms in (1, 3):
        want = np.asarray(ref_ops.shgemm_fused(
            jnp.asarray(a), JKEY, 20, dist="very_sparse", s=4.0, terms=terms,
            blocks=REF_BLOCKS))
        got = ops.shgemm_fused(torch.from_numpy(a), KEY, 20, dist="very_sparse",
                               s=4.0, terms=terms, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist", ["srht", "khatri_rao"])
def test_structured_dists_rejected_like_reference(dist):
    with pytest.raises(ValueError, match="structured family"):
        ref_ops.shgemm_fused(jnp.ones((8, 128)), JKEY, 8, dist=dist)
    with pytest.raises(ValueError, match="structured family"):
        ops.shgemm_fused(torch.ones((8, 128)), KEY, 8, dist=dist, device="cpu")


@pytest.mark.parametrize("kw,match", [
    ({"row_offset": 100}, "not a multiple"),
    ({"row_offset": -256}, "must be >= 0"),
    ({"col_offset": -1}, "must be >= 0"),
])
def test_offset_errors_like_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        ref_ops.shgemm_fused(jnp.ones((8, 256)), JKEY, 8, blocks=(8, 128, 256), **kw)
    with pytest.raises(ValueError, match=match):
        ops.shgemm_fused(torch.ones((8, 256)), KEY, 8, blocks=(32, 32, 256),
                         device="cpu", **kw)


def test_bad_omega_dtype_raises():
    with pytest.raises(TypeError, match="omega_dtype"):
        ops.shgemm_fused(torch.ones((8, 64)), KEY, 8, omega_dtype=torch.float32,
                         device="cpu")


@pytest.mark.parametrize("m,n,k", [(4096, 266, 4096), (256, 32, 65536), (7, 3, 130)])
@pytest.mark.parametrize("fused", [True, False])
def test_hbm_bytes_modeled_matches_reference(m, n, k, fused):
    assert kf.hbm_bytes_modeled(m, n, k, fused=fused) == \
        ref_kf.hbm_bytes_modeled(m, n, k, fused=fused)


@pytest.mark.parametrize("dist,s", [("gaussian", None), ("achlioptas", None),
                                    ("very_sparse", None), ("very_sparse", 2.5)])
def test_resolve_s_matches_reference(dist, s):
    assert kf._resolve_s(dist, s, 1000) == ref_kf._resolve_s(dist, s, 1000)


def test_key_pair_forms():
    assert kf.key_pair((1, 2)) == (1, 2)
    assert kf.key_pair(np.array([[3, 4]], np.uint32)) == (3, 4)
    assert kf.key_pair(torch.tensor([5, 2**32 + 6])) == (5, 6)



# Kernel 2's planner (ops.fused_plan): the main path's shapes, then others.
PLAN_SHAPES = {"rsvd": (4096, 266, 4096), "hosvd": (256, 32, 65536),
               "sthosvd_mode1": (256, 32, 8192), "sthosvd_mode2": (256, 32, 1024),
               "small": (40, 30, 256), "odd": (300, 130, 700), "tiny": (7, 3, 130),
               "tall": (20000, 8, 3000)}


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_fused_plan_is_launchable(shape):
    m, n, k = PLAN_SHAPES[shape]
    bm, bn, bk, splits = ops.fused_plan(m, n, k)
    k_pad = -(-k // bk) * bk
    k1.check_plan(-(-m // bm) * bm, -(-n // bn) * bn, k_pad, bm, bn, bk, splits)
    assert (k_pad // bk) % splits == 0
    assert bk == ops.shgemm_plan(m, n, k)[2]  # kernel 1's bk: equal bits
    grid = -(-m // bm) * -(-n // bn)
    if grid * (k_pad // bk) >= ops.SM_COUNT:
        assert grid * splits >= ops.SM_COUNT
    else:
        assert splits == k_pad // bk

    def fills(d):  # at least SM_COUNT blocks, filling WAVE_FILL of their waves
        waves = -(-grid * d // ops.SM_COUNT)
        return grid * d >= max(ops.SM_COUNT, ops.WAVE_FILL * ops.SM_COUNT * waves)
    smaller = [d for d in range(1, splits) if (k_pad // bk) % d == 0]
    assert not any(fills(d) for d in smaller)  # the least split count that does


def test_fused_plan_at_the_main_path_shapes():
    """rSVD's 144 output tiles would leave a second wave 9 % full, so K is
    split in 4 (576 blocks, 87 % of 5 waves); RP-HOSVD's one 256 x 32
    output tile is split over all its tiles; Omega is hashed once per 256
    rows."""
    assert ops.fused_plan(*PLAN_SHAPES["rsvd"]) == (256, 32, 256, 4)
    assert ops.fused_plan(*PLAN_SHAPES["hosvd"]) == (256, 32, 256, 256)
    assert ops.fused_plan(*PLAN_SHAPES["sthosvd_mode1"]) == (256, 32, 256, 32)
    assert ops.fused_plan(*PLAN_SHAPES["sthosvd_mode2"]) == (256, 32, 256, 4)


def test_fused_plan_caps_the_workspace():
    """Split-K needs a workspace of k / bk output-sized tiles: past
    MAX_WORKSPACE_BYTES the planner keeps one split."""
    m, n, k = 8192, 32, 2**20  # 4096 tiles of a 32-block grid: 4 GiB
    assert k1.workspace_bytes(m, n, k, 256, 2) > ops.MAX_WORKSPACE_BYTES
    assert ops.fused_plan(m, n, k) == (256, 32, 256, 1)
    assert ops.fused_plan(m, n, k // 8)[3] > 1  # 512 MiB: split


@pytest.mark.parametrize("m,n,k,bk,splits", [(256, 32, 65536, 256, 256),
                                             (4096, 288, 4096, 256, 16),
                                             (64, 64, 1024, 128, 2),
                                             (4096, 288, 4096, 256, 1)])
def test_workspace_bytes_formula(m, n, k, bk, splits):
    want = 0 if splits == 1 else (k // bk) * m * n * 4
    assert k1.workspace_bytes(m, n, k, bk, splits) == want
    if (m, n, k) == (256, 32, 65536):
        assert want == 8 * 2**20  # the HOSVD shape's W: 8 MiB


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("dist", ["gaussian", "achlioptas"])
def test_ops_shgemm_fused_with_splits_matches_reference(dist, splits):
    """``splits=`` pins the split count; on the CPU it validates the plan
    and runs the plain version, which still matches the reference."""
    m, k, n = 40, 1024, 30  # bk 256: four tiles
    rng = np.random.default_rng(9)
    a = (rng.standard_normal((m, k)) if dist == "gaussian"  # as above
         else rng.integers(-2**14, 2**14, (m, k))).astype(np.float32)
    want = np.asarray(ref_ops.shgemm_fused(jnp.asarray(a), JKEY, n, dist=dist,
                                           blocks=(8, 128, 256)))
    got = ops.shgemm_fused(torch.from_numpy(a), KEY, n, dist=dist, splits=splits,
                           device="cpu").numpy()
    if dist != "gaussian":
        np.testing.assert_array_equal(got, want)
        return
    gap = _lowp_omega_gap(jnp.bfloat16, torch.bfloat16, dist, k, n, None, (0, 0))
    allowance = np.abs(a.astype(np.float64)) @ gap
    np.testing.assert_array_less(np.abs(got - want) - allowance,
                                 1e-4 + 1e-5 * np.abs(want))


@pytest.mark.parametrize("kw,match", [
    ({"blocks": (256, 64, 256)}, "unsupported"),
    ({"blocks": (128, 32, 48)}, "unsupported"),
    ({"splits": 3}, "must be an integer"),
    ({"splits": 0}, "must be an integer"),
    ({"splits": 8}, "must be an integer"),
    ({"splits": 2.0}, "must be an integer"),
])
def test_fused_bad_plan_raises_on_cpu(kw, match):
    with pytest.raises(ValueError, match=match):
        ops.shgemm_fused(torch.ones((40, 1024)), KEY, 30, device="cpu", **kw)


@pytest.mark.parametrize("tile", k1.TILES, ids=str)
def test_fused_tiles_fit_shared_memory(tile):
    """Every instantiated tile fits the 227 KB a block may use; the
    mirror's formula is csrc/'s at the planner's 256 x 32 tile."""
    bm, bn = tile
    assert kf.smem_bytes(bm, bn) <= 232448
    assert bm * bn // 32 <= 1024  # threads: one warp per 32 x 32
    if tile == (256, 32):
        assert kf.smem_bytes(bm, bn) == 3 * 256 * 40 * 4 + 2 * 32 * 40 * 2 + 256
