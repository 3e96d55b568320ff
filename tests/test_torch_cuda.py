"""The four hand-written kernels against their plain PyTorch versions on the
card, and a smoke-size engine lockstep through kernel 4.  A CUDA kernel has
no CPU mode, so every test here carries the ``cuda`` marker and skips
without a card.  The file imports no JAX (the
machine with the card has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.configs.base import smoke_config
from repro_torch.convert import key_from_seed
from repro_torch.kernels import factored_decode as k4
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm as k1
from repro_torch.kernels import shgemm_fused as k2
from repro_torch.launch import serve as launch
from repro_torch.models import registry as R
from repro_torch.serve.engine import Engine

pytestmark = pytest.mark.cuda

LOWP_TERMS = [(torch.bfloat16, 1), (torch.bfloat16, 2), (torch.bfloat16, 3),
              (torch.float16, 1), (torch.float16, 2)]
OMEGA_DTYPES = [torch.bfloat16, torch.float16, torch.float8_e4m3fn]
KEY = key_from_seed(42)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _a(gen, m=300, k=700):
    return torch.randn((m, k), generator=gen, device="cuda") / k**0.5


@pytest.mark.parametrize("lowp,terms", LOWP_TERMS, ids=str)
@pytest.mark.parametrize("blocks", [None, (32, 64, 64)], ids=str)
def test_shgemm_kernel_matches_plain(gen, lowp, terms, blocks):
    a = _a(gen)
    b = torch.randn((700, 130), generator=gen, device="cuda").to(lowp)
    before = k1.launches
    got = ops.shgemm(a, b, terms=terms, blocks=blocks)
    assert k1.launches == before + 1
    torch.testing.assert_close(got, k1.shgemm_plain(a, b, terms), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dist", ["gaussian", "achlioptas", "very_sparse"])
@pytest.mark.parametrize("omega_dtype", OMEGA_DTYPES, ids=str)
def test_fused_kernel_matches_plain(gen, dist, omega_dtype):
    a = _a(gen)
    before = k2.launches
    got = ops.shgemm_fused(a, KEY, 130, dist=dist, omega_dtype=omega_dtype,
                           blocks=(64, 32, 128), row_offset=256, col_offset=3)
    assert k2.launches == before + 1
    lowp = torch.bfloat16 if omega_dtype == torch.float8_e4m3fn else omega_dtype
    plain = k2.shgemm_fused_plain(a, KEY, 130, dist=dist,
                                  s=k2._resolve_s(dist, None, 700),
                                  store_dtype=omega_dtype, lowp_dtype=lowp,
                                  row_offset=256, col_offset=3)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dist", ["achlioptas", "very_sparse"])
def test_fused_equals_shgemm_of_fused_omega(gen, dist):
    """Same lattice, same blocks: the kernels agree bit for bit (for the sign
    dists, whose values are exact on every backend)."""
    a = _a(gen)
    omega = k2.reference_omega(KEY, (700, 130), dist=dist, dtype=torch.bfloat16)
    blocks = (64, 64, 128)
    torch.testing.assert_close(ops.shgemm_fused(a, KEY, 130, dist=dist, blocks=blocks),
                               ops.shgemm(a, omega, blocks=blocks), rtol=0, atol=0)


# Kernel 2's plans: (bm, bn, splits) sharing bk = 128 on 16 tiles of K.
FUSED_PLANS = [(256, 32, 1), (256, 32, 2), (256, 32, 16), (128, 64, 4),
               (64, 32, 8), (32, 64, 1), (32, 32, 16)]


@pytest.mark.parametrize("dist", ["gaussian", "very_sparse"])
@pytest.mark.parametrize("plan", FUSED_PLANS[1:], ids=str)
def test_fused_bit_identical_across_plans(gen, dist, plan):
    """The output bits depend on bk alone: not on bm, bn or the split
    count, and the split path launches the reduction."""
    a = _a(gen, 512, 2048)
    bm, bn, splits = plan
    want = ops.shgemm_fused(a, KEY, 64, dist=dist, blocks=(256, 32, 128), splits=1)
    before = k2.reductions
    got = ops.shgemm_fused(a, KEY, 64, dist=dist, blocks=(bm, bn, 128), splits=splits)
    assert k2.reductions == before + (splits > 1)
    assert torch.equal(got, want)


HOSVD_LIKE = (256, 16384, 32)


@pytest.mark.parametrize("lowp", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("plan", FUSED_PLANS[1:], ids=str)
def test_shgemm_bit_identical_across_plans(gen, lowp, plan):
    """Kernel 1 on the same loop: its bits depend on bk alone, not on bm,
    bn or the split count, and the split path launches the reduction."""
    a = _a(gen, 512, 2048)
    b = torch.randn((2048, 64), generator=gen, device="cuda").to(lowp)
    bm, bn, splits = plan
    want = ops.shgemm(a, b, blocks=(256, 32, 128), splits=1)
    before = k1.reductions
    got = ops.shgemm(a, b, blocks=(bm, bn, 128), splits=splits)
    assert k1.reductions == before + (splits > 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lowp,terms", LOWP_TERMS, ids=str)
def test_shgemm_planner_occupancy_is_the_calculators(gen, lowp, terms):
    """The planner's blocks an SM of kernel 1's 128 x 32 tile are what the
    CUDA occupancy calculator gives for the built kernel."""
    assert k1.blocks_per_sm(128, 32, terms, lowp) == ops.SHGEMM_PER_SM[terms]


@pytest.mark.parametrize("shape", [HOSVD_LIKE, (300, 700, 130), (37, 5000, 70)],
                         ids=str)
@pytest.mark.parametrize("lowp,terms", LOWP_TERMS, ids=str)
def test_shgemm_planned_matches_plain(gen, shape, lowp, terms):
    """Under ``shgemm_plan`` (split-K at the HOSVD-like shape, padding at
    the ragged ones) kernel 1 matches its plain version."""
    m, k, n = shape
    a = _a(gen, m, k)
    b = torch.randn((k, n), generator=gen, device="cuda").to(lowp)
    before = k1.launches
    got = ops.shgemm(a, b, terms=terms)
    assert k1.launches == before + 1
    if shape == HOSVD_LIKE:
        assert ops.shgemm_plan(m, n, k)[3] > 1
    torch.testing.assert_close(got, k1.shgemm_plain(a, b, terms), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw,match", [
    ({"blocks": (256, 64, 256)}, "unsupported"),
    ({"blocks": (256, 32, 100)}, "unsupported"),
    ({"blocks": (256, 32, 256), "splits": 3}, "must be an integer"),
    ({"splits": 0}, "must be an integer"),
    ({"splits": 5}, "must be an integer"),
])
def test_shgemm_bad_plan_raises(gen, kw, match):
    a = _a(gen, 256, 1024)
    b = torch.ones((1024, 32), dtype=torch.bfloat16, device="cuda")
    before = k1.launches
    with pytest.raises(ValueError, match=match):
        ops.shgemm(a, b, **kw)
    assert k1.launches == before


@pytest.mark.parametrize("dist", ["gaussian", "achlioptas", "very_sparse"])
@pytest.mark.parametrize("omega_dtype", OMEGA_DTYPES, ids=str)
def test_fused_equals_kernel1_on_chip_omega(gen, dist, omega_dtype):
    """At an RP-HOSVD-like shape under the planner's split count, kernel 2
    equals kernel 1 applied to kernel 2's own Omega, bit for bit.  The two
    share the main loop and differ in their B producers; kernel 1 runs on
    32 x 32 blocks with one split, on the loop's direct path."""
    m, k, n = HOSVD_LIKE
    a = _a(gen, m, k)
    bk = ops.fused_plan(m, n, k)[2]
    s = k2._resolve_s(dist, None, k)
    kw = dict(dist=dist, omega_dtype=omega_dtype, s=s, row_offset=2 * bk,
              col_offset=3)
    omega = ops.chip_omega(KEY, k, n, **kw)
    got = ops.shgemm_fused(a, KEY, n, **kw)
    assert ops.fused_plan(m, n, k)[3] > 1
    assert torch.equal(got, ops.shgemm(a, omega, blocks=(32, 32, bk), splits=1))


@pytest.mark.parametrize("kw,match", [
    ({"blocks": (256, 64, 256)}, "unsupported"),
    ({"blocks": (256, 32, 100)}, "unsupported"),
    ({"blocks": (256, 32, 256), "splits": 3}, "must be an integer"),
    ({"splits": 0}, "must be an integer"),
    ({"splits": 5}, "must be an integer"),
])
def test_fused_bad_plan_raises(gen, kw, match):
    a = _a(gen, 256, 1024)
    before = k2.launches
    with pytest.raises(ValueError, match=match):
        ops.shgemm_fused(a, KEY, 32, **kw)
    assert k2.launches == before


def test_kernel_rejects_misaligned_operand(gen):
    a = _a(gen, 64, 65)[:, 1:]  # contiguous rows are not the point: a view
    b = torch.ones((64, 32), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        k1.shgemm_pallas(a, b, bm=32, bn=32, bk=32)


# ---------------------------------------------------------------------------
# Kernel 3 (flash attention) and kernel 4 (factored decode)
# ---------------------------------------------------------------------------


def _row_rel_err(got, want):
    """Largest ||got - want|| / ||want|| over the rows of the last axis: an
    attention output element at position p is ~sqrt(e / p) with randn
    inputs, below the elementwise atol at long S; this scales with it."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


# Bound of _row_rel_err: bf16 rounds P and the output (2^-9 relative each);
# f32 runs the hi/lo split products.
ROW_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}


def _qkv(gen, b, s, h, kvh, hd, dtype):
    mk = lambda n: torch.randn((b, s, n, hd), generator=gen,  # noqa: E731
                               device="cuda").to(dtype)
    return mk(h), mk(kvh), mk(kvh)


@pytest.mark.parametrize("b,s,h,kvh,hd", [
    (2, 256, 8, 4, 64), (1, 512, 4, 1, 128), (2, 128, 4, 4, 32),
    (2, 200, 4, 2, 64), (2, 32, 4, 2, 16), (1, 300, 8, 1, 128)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_bf16(gen, b, s, h, kvh, hd, causal):
    """bf16 at the reference's tolerance (P is rounded to bf16 for P.V);
    S = 200 and 300 exercise the ragged edge the kernel masks itself."""
    q, k, v = _qkv(gen, b, s, h, kvh, hd, torch.bfloat16)
    before = k3.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert k3.launches == before + 1
    want = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=3e-2)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


@pytest.mark.parametrize("s,causal", [(128, True), (200, True), (96, False)])
def test_flash_kernel_matches_plain_f32(gen, s, causal):
    """f32 inputs run the hi/lo split products: f32 accuracy."""
    q, k, v = _qkv(gen, 1, s, 4, 2, 64, torch.float32)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


@pytest.mark.parametrize("s", [1, 63, 65, 1000, 4096])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ring_edges_bf16(gen, s, g, hd, causal):
    """The pipelined kernel against its plain version across sequence
    lengths that are below, at and past one 64-key tile and the ring's
    depth, every group size, both head sizes and both masks: the mask runs
    only on diagonal and ragged-edge tiles, and the zero-filled copies past
    S must add nothing."""
    q, k, v = _qkv(gen, 1 if s == 4096 else 2, s, 8, 8 // g, hd, torch.bfloat16)
    before = k3.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert k3.launches == before + 1
    want = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=3e-2)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


@pytest.mark.parametrize("s", [1, 63, 65, 1000])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ring_edges_f32(gen, s, g, causal):
    """f32 inputs run the same ring of f32 tiles with the hi/lo split:
    f32 accuracy at the same edges."""
    q, k, v = _qkv(gen, 2, s, 8, 8 // g, 128, torch.float32)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


def test_flash_kernel_two_blocks_an_sm(gen):
    """The design point: at hd 128 in bf16 two 4-warp blocks share an SM
    (registers and 68 KB of shared memory each allow it)."""
    assert k3.blocks_per_sm(128, torch.bfloat16) == 2


@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_kernel_negative_and_zero_scale(gen, scale):
    """The kernel's exp2 softmax folds scale * log2(e) into one FMA, which
    needs scale > 0; the wrapper negates q for a negative scale and zeroes
    it for scale 0."""
    q, k, v = _qkv(gen, 1, 200, 4, 2, 64, torch.float32)
    got = ops.flash_attention(q, k, v, causal=True, scale=scale)
    want = k3.flash_attention_plain(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


@pytest.mark.parametrize("s", [448, 4096, 4097])
@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_every_group_bf16(gen, s, g, hd, causal):
    """Every group size from 1 to 8 over two kv heads: a block holds bq =
    16 * (8 // G) positions of each of its G heads, so at G = 3, 5, 6, 7
    its last 128 - G * bq rows are dead, and must read no head of the next
    group and write nothing.  S = 448 is whisper's text context, 4096
    llava's prefill (576 image rows + 3520 tokens), 4097 a ragged edge."""
    q, k, v = _qkv(gen, 1, s, 2 * g, 2, hd, torch.bfloat16)
    before = k3.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert k3.launches == before + 1
    want = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=3e-2)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


@pytest.mark.parametrize("s", [65, 448])
@pytest.mark.parametrize("g", [3, 5, 7])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_odd_groups_f32(gen, s, g, hd, causal):
    """The groups that leave dead rows, in f32 (the hi/lo split products):
    f32 accuracy."""
    q, k, v = _qkv(gen, 2, s, 2 * g, 2, hd, torch.float32)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


@pytest.mark.parametrize("b,s,h,kvh,hd", [(1, 4096, 56, 8, 128),
                                          (8, 448, 20, 20, 64)], ids=str)
def test_flash_kernel_llava_and_whisper_prefill_shapes(gen, b, s, h, kvh, hd):
    """The two prefills of the enc-dec and VLM slice: llava-next-34b's (1,
    576 + 3520, 56|8, 128), G 7, and whisper-large-v3's decoder (8, 448,
    20|20, 64), G 1, bf16 causal."""
    q, k, v = _qkv(gen, b, s, h, kvh, hd, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = k3.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=3e-2)
    assert _row_rel_err(got, want) <= ROW_REL[q.dtype]


def _fdec_inputs(gen, b=2, s=32, h=4, kvh=2, hd=16, r=5, comp=(12, 0), wp=20,
                 dtype=torch.float32, garbage_past_wp=False):
    """Factored-decode state honoring the cache contract: us rows >=
    comp_len zero, dense rows < comp_len zero (swapped out)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    comp_t = torch.tensor(comp, dtype=torch.int32, device="cuda")
    idx = torch.arange(s, device="cuda")
    pre = idx[None, :] < comp_t[:, None].long()                # (B, S)
    us_k = rn(b, kvh, s, r) * pre[:, None, :, None]
    us_v = rn(b, kvh, s, r) * pre[:, None, :, None]
    vt_k, vt_v = rn(b, kvh, r, hd), rn(b, kvh, r, hd)
    kd = rn(b, s, kvh, hd).masked_fill(pre[..., None, None], 0.0)
    vd = rn(b, s, kvh, hd).masked_fill(pre[..., None, None], 0.0)
    if not garbage_past_wp:
        dead = (idx > wp)[None, :, None, None]
        kd, vd = kd.masked_fill(dead, 0.0), vd.masked_fill(dead, 0.0)
    q = rn(b, 1, h, hd)
    return (q.to(dtype), kd.to(dtype), vd.to(dtype), us_k, vt_k, us_v, vt_v,
            comp_t)


def _fdec_both(args, wp, *, cap=0.0, block_kv=8, hd=16):
    scale = hd ** -0.5
    before = k4.launches
    got = ops.factored_decode_attention(*args, wp, scale=scale, cap=cap,
                                        block_kv=block_kv)
    assert k4.launches == before + 1
    want = k4.factored_decode_plain(*args, wp, scale=scale, cap=cap)
    return got, want


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("comp", [(0, 0), (21, 21), (12, 0), (8, 21), (12, 5)])
def test_fdec_kernel_matches_plain(gen, h, kvh, cap, comp):
    args = _fdec_inputs(gen, h=h, kvh=kvh, comp=comp, wp=20)
    got, want = _fdec_both(args, 20, cap=cap)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_kv", [8, 16, 32, 64])
@pytest.mark.parametrize("wp", [7, 8, 25, 39])
def test_fdec_kernel_blocks_and_write_pos(gen, block_kv, wp):
    args = _fdec_inputs(gen, s=40, comp=(min(13, wp + 1), 0), wp=wp)
    got, want = _fdec_both(args, wp, block_kv=block_kv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fdec_kernel_skips_rows_past_write_pos_and_unused_factors(gen):
    """Rows past write_pos are never read (garbage there changes no bit),
    and a batch with comp_len == 0 never reads its factors (NaN there
    changes no bit)."""
    wp = 17
    g2 = torch.Generator(device="cuda")
    clean = _fdec_inputs(g2.manual_seed(5), comp=(9, 0), wp=wp)
    dirty = _fdec_inputs(g2.manual_seed(5), comp=(9, 0), wp=wp,
                         garbage_past_wp=True)
    out_c, _ = _fdec_both(clean, wp)
    out_d, want_d = _fdec_both(dirty, wp)
    torch.testing.assert_close(out_d, want_d, rtol=1e-5, atol=1e-5)
    assert torch.equal(out_c, out_d)
    args = list(_fdec_inputs(gen, comp=(0, 0), wp=20))
    out, _ = _fdec_both(tuple(args), 20)
    for i in (3, 4, 5, 6):
        args[i] = torch.full_like(args[i], float("nan"))
    out_p, _ = _fdec_both(tuple(args), 20)
    assert torch.equal(out, out_p)


def test_fdec_kernel_engine_shape_bf16(gen):
    """The engine's shape: 8 slots x 2048 rows x 8 kv heads x 128, r = 32,
    bf16 cache, comp_len mixed (0 / all / partial)."""
    comp = (0, 201, 128, 192, 0, 64, 150, 201)
    args = _fdec_inputs(gen, b=8, s=2048, h=16, kvh=8, hd=128, r=32,
                        comp=comp, wp=200, dtype=torch.bfloat16,
                        garbage_past_wp=True)
    got, want = _fdec_both(args, 200, block_kv=256, hd=128)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("wp", [190, 2047])
def test_fdec_kernel_llava_engine_shape_groups_7(gen, wp):
    """llava-next-34b's engine: 4 slots x 2048 rows x 8 kv heads x 128, G
    = 56 / 8 = 7, r = 32, bf16 cache, comp_len mixed, at the planner's
    split (its shared memory grows with G)."""
    comp = {190: (128, 0, 191, 64), 2047: (1984, 0, 2048, 1)}[wp]
    args = _fdec_inputs(gen, b=4, s=2048, h=56, kvh=8, hd=128, r=32,
                        comp=comp, wp=wp, dtype=torch.bfloat16,
                        garbage_past_wp=True)
    assert k4.decode_plan(4, 8, 2048, 128, 32, 7).smem <= k4.SMEM_LIMIT
    before = k4.launches
    got = k4.factored_decode_attention(*args, wp, scale=128 ** -0.5)
    assert k4.launches == before + 1
    want = k4.factored_decode_plain(*args, wp, scale=128 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("wp", [0, 7, 8, 25, 39, 47])
@pytest.mark.parametrize("splits", ["one", "planner", "twice"])
def test_fdec_kernel_splits_and_write_pos(gen, splits, wp):
    """P = 1, the planner's and twice it (5 and 10 splits of 6 grains: at
    small clocks most shares are empty) against the plain version."""
    s = 48
    args = _fdec_inputs(gen, s=s, comp=(min(13, wp + 1), 0), wp=wp)
    p = k4.decode_plan(2, 2, s, 16, 5, 2).splits
    p = {"one": 1, "planner": p, "twice": 2 * p}[splits]
    before = k4.launches
    got = k4.factored_decode_attention(*args, wp, scale=0.25, splits=p)
    assert k4.launches == before + 1
    want = k4.factored_decode_plain(*args, wp, scale=0.25)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,r", [(16, 5), (20, 8), (20, 6), (128, 32)],
                         ids=str)
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=str)
def test_fdec_kernel_dtype_pairings(gen, hd, r, q_dtype, kv_dtype):
    """Every q/cache pairing, over the 16-byte and the scalar loads (hd 20
    in bf16 and r 5 / 6 do not fill a 16-byte vector).  An f32 output
    holds 1e-5; a bf16 one is rounded once, 1e-2."""
    args = list(_fdec_inputs(gen, s=40, hd=hd, r=r, comp=(13, 0), wp=30,
                             dtype=kv_dtype))
    args[0] = args[0].to(q_dtype)
    got, want = _fdec_both(tuple(args), 30, hd=hd)
    assert got.dtype == q_dtype
    tol = 1e-5 if q_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("h,kvh,hd,r,dtype", [
    (32, 2, 128, 32, torch.bfloat16),   # 256 (head, vector) pairs > 128 threads
    (4, 2, 256, 64, torch.float32),     # two vectors a lane; r > 32 in the merge
    (4, 2, 15, 5, torch.bfloat16),      # odd bf16 rows: 2-byte copies
], ids=str)
def test_fdec_kernel_wide_and_odd_shapes(gen, h, kvh, hd, r, dtype):
    args = _fdec_inputs(gen, s=40, h=h, kvh=kvh, hd=hd, r=r, comp=(13, 0),
                        wp=30, dtype=dtype)
    got, want = _fdec_both(args, 30, hd=hd)
    # f32 at 1e-4: rank-64 factors make K and V entries ~8, and an output
    # sums ~320 such products in another order than the einsums'
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("wp", [0, 20, 31])
def test_fdec_kernel_tensor_write_pos_bit_equal(gen, wp):
    """write_pos as an int32 tensor on the card gives the int path's bits;
    repeated calls are bit-identical (the merge's order is fixed and its
    tickets are reset); a clock outside the cache gives NaN."""
    args = _fdec_inputs(gen, comp=(min(12, wp + 1), 0), wp=wp)
    by_int = k4.factored_decode_attention(*args, wp, scale=0.25)
    clock = torch.tensor([wp], dtype=torch.int32, device="cuda")
    for _ in range(3):
        assert torch.equal(k4.factored_decode_attention(*args, clock, scale=0.25),
                           by_int)
    torch.testing.assert_close(by_int, k4.factored_decode_plain(
        *args, wp, scale=0.25), rtol=1e-5, atol=1e-5)
    past = torch.tensor([32], dtype=torch.int32, device="cuda")
    assert k4.factored_decode_attention(*args, past, scale=0.25).isnan().all()


def test_fdec_kernel_graph_replay_follows_device_clock(gen):
    """The launch does not depend on the clock: captured once in a CUDA
    graph with write_pos as an int32 on the card, it follows the clock when
    the graph is replayed at other values of it."""
    args = _fdec_inputs(gen, s=40, comp=(13, 0), wp=39)
    clock = torch.zeros(1, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k4.factored_decode_attention(*args, clock, scale=0.25)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = k4.factored_decode_attention(*args, clock, scale=0.25)
    for wp in (0, 12, 13, 39, 20):
        clock.fill_(wp)
        graph.replay()
        torch.testing.assert_close(out, k4.factored_decode_plain(
            *args, wp, scale=0.25), rtol=1e-5, atol=1e-5)


def test_fdec_kernel_full_slot_bf16(gen):
    """The engine's shape with every row live (write_pos 2047) and comp_len
    mixed up to 1984, bf16 cache, at the planner's split."""
    comp = (1984, 0, 1024, 1984, 64, 1920, 2048, 1)
    args = _fdec_inputs(gen, b=8, s=2048, h=16, kvh=8, hd=128, r=32,
                        comp=comp, wp=2047, dtype=torch.bfloat16)
    got = k4.factored_decode_attention(*args, 2047, scale=128 ** -0.5)
    want = k4.factored_decode_plain(*args, 2047, scale=128 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(k4.factored_decode_attention(*args, 2047, scale=128 ** -0.5),
                       got)


@pytest.mark.parametrize("state", ["early", "full"])
def test_fdec_kernel_gemma2_engine_shape_bf16(gen, state):
    """gemma2-2b's global layers in the engine: 8 slots x 8192 rows x 4 kv
    heads x 256 (G = 2), r = 32, the attention softcap 50, bf16 cache,
    comp_len mixed; early in the slot (write_pos 4700, garbage past it) and
    at the full slot (write_pos 8191)."""
    wp, comp = {"early": (4700, (0, 4701, 4608, 1024, 0, 64, 4672, 1)),
                "full": (8191, (8128, 0, 4096, 8128, 64, 8064, 8192, 1))}[state]
    args = _fdec_inputs(gen, b=8, s=8192, h=8, kvh=4, hd=256, r=32, comp=comp,
                        wp=wp, dtype=torch.bfloat16, garbage_past_wp=True)
    before = k4.launches
    got = k4.factored_decode_attention(*args, wp, scale=256 ** -0.5, cap=50.0)
    assert k4.launches == before + 1
    want = k4.factored_decode_plain(*args, wp, scale=256 ** -0.5, cap=50.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_fdec_kernel_head_dim_256_groups_2_f32(gen, cap):
    """gemma2's head shape (hd 256, two q heads a kv head) at a small S in
    f32, with and without the tanh softcap (1e-4: rank-32 factors and
    256-wide rows sum in another order than the einsums)."""
    args = _fdec_inputs(gen, b=3, s=96, h=8, kvh=4, hd=256, r=32,
                        comp=(40, 0, 90), wp=90)
    got, want = _fdec_both(args, 90, cap=cap, block_kv=None, hd=256)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_rolling_finalize_through_kernel2_bitwise(gen):
    """stream.rolling_* with kernel 2 (the default method) over a stream
    longer than two windows in ragged tiles, gap included: the finalized
    sketch equals kernel 2's fresh sketch of the trailing window bit for
    bit."""
    from repro_torch import stream
    n, p, window = 256, 40, 512
    a = torch.randn((1300, n), generator=gen, device="cuda")
    rs = stream.rolling_init(KEY, n, p, window=window, device="cuda")
    before, pos = k2.launches, 0
    for c in (100, 1, 300, 257, 512, 77):
        rs = stream.rolling_update(rs, a[pos:pos + c], pos)
        pos += c
    assert k2.launches - before == 6
    rs = stream.rolling_update(rs, a[pos + 20:1300], pos + 20)   # a 20-row gap
    rows = a[1300 - window:1300].clone()
    rows[window - (1300 - pos):window - (1300 - pos) + 20] = 0.0
    fresh = stream.update(stream.init(KEY, n, p, max_rows=window,
                                      method="shgemm_fused", device="cuda"),
                          rows, 0)
    assert torch.equal(stream.rolling_finalize(rs).y, fresh.y)


def test_scheduler_kernel_path_matches_plain_path_smoke():
    """Smoke gemma2 (16-row rings) through the scheduler on the card: the
    kernel configuration (kernel 4 on the compressed global layers) and
    the plain one give the same virtual-clock SLO summary and swaps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.serve import loadgen
    cfg = smoke_config(R.get_arch("gemma2-2b")).with_(activation_dtype="float32")
    params = launch.init_weights(cfg, seed=0, device="cuda")
    trace = loadgen.generate_trace(3, 6, 500.0, vocab=cfg.vocab,
                                   prompt_short=(3, 6), prompt_long=(20, 30),
                                   max_new_range=(3, 20))
    kw = dict(slots=3, max_seq=48, kv_sketch_rank=8, kv_compress_ratio=2.0,
              prefill_chunk=4, device="cuda")
    runs = []
    for c in (cfg, cfg.with_(use_flash_kernel=True)):
        before = k4.launches
        res = launch.run_scheduler(c, params, trace, **kw)
        runs.append((res["summary"], k4.launches - before,
                     list(res["scheduler"].model._kv_comp_len)))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]
    assert runs[0][1] == 0 and runs[1][1] > 0
    assert runs[1][0]["accounting"]["in_flight"] == 0


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_engine_kernel_path_matches_plain_path_smoke(act):
    """Smoke qwen3: the engine decoding through kernel 4 stays in lockstep
    with the one decoding through the plain oracle, with the same
    compression history; kernel 4 runs once per layer per decode step.
    f32 activations at the reference's 1e-1; bf16 activations within two
    bf16 ulps of the largest logit (two summation orders round the bf16
    hidden state differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype=act)
    params = launch.init_weights(cfg, seed=0, device="cuda")
    kw = dict(slots=2, max_seq=48, kv_sketch_rank=4, kv_compress_ratio=2.0,
              device="cuda")
    plain = Engine(cfg, params, **kw)
    kern = Engine(cfg.with_(use_flash_kernel=True), params, **kw)
    before = k4.launches
    res = launch.lockstep([plain, kern], [[5, 7, 11, 2], [3, 9, 1, 4]],
                          max_new=16)
    bound = 1e-1 if act == "float32" else 2 * 2.0 ** (
        math.floor(math.log2(max(res["peaks"]))) - 7)
    assert res["diffs"] and max(res["diffs"]) <= bound, (res["diffs"], bound)
    assert res["comp_len"][0] == res["comp_len"][1]
    assert (kern._kv_comp_len > 0).all()
    assert k4.launches - before == res["steps"] * cfg.n_layers


# ---------------------------------------------------------------------------
# The streamed path: kernels 1-2 at lattice offsets on the streamed shapes
# ---------------------------------------------------------------------------

STREAM_N, STREAM_P = 1024, 74            # n_cols and p of the streamed tests


@pytest.mark.parametrize("case", ["row_tile", "widen", "left_on_grid",
                                  "left_off_grid", "cols_tile"])
def test_fused_at_streamed_offsets_matches_plain(gen, case):
    """Kernel 2 where the stream runs it: a 256-row tile (col_offset 0 or
    p_old), the left sketch A_tile^T . Psi^T at row offsets on and off its
    bk grid, and a partial-width tile at a column offset."""
    from repro_torch.stream import state as st_mod
    a = _a(gen, 320, STREAM_N)
    l = 2 * STREAM_P + 1
    before = k2.launches
    if case == "row_tile":
        got = ops.shgemm_fused(a[:256], KEY, STREAM_P)
        want = k2.shgemm_fused_plain(a[:256], KEY, STREAM_P)
    elif case == "widen":
        got = ops.shgemm_fused(a[:256], KEY, 10, col_offset=STREAM_P)
        want = k2.shgemm_fused_plain(a[:256], KEY, 10, col_offset=STREAM_P)
    elif case == "left_on_grid":
        got = st_mod.fused_at_row_offset(a[:256].T, KEY, l, 768)
        want = k2.shgemm_fused_plain(a[:256].T, KEY, l, row_offset=768)
    elif case == "left_off_grid":
        got = st_mod.fused_at_row_offset(a.T, KEY, l, 320)
        want = k2.shgemm_fused_plain(a.T, KEY, l, row_offset=320)
    else:
        got = st_mod.fused_at_row_offset(a[:, 100:612], KEY, STREAM_P, 100,
                                         col_offset=3)
        want = k2.shgemm_fused_plain(a[:, 100:612], KEY, STREAM_P,
                                     row_offset=100, col_offset=3)
    assert k2.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tile", [256, 320, 1000])
def test_streamed_rows_equal_oneshot_bitwise(gen, tile):
    """Kernel 2's bits depend on bk, which depends on n_cols alone: streamed
    row tiles (regular, ragged, from host memory through the pinned
    prefetch) give the one-shot sketch's rows bit for bit, and a widened
    state equals a fresh sketch at the grown width."""
    from repro_torch import main_path, stream
    from repro_torch.core import projection as proj
    a = _a(gen, 2000, STREAM_N)
    src = stream.ArraySource(a.cpu(), tile)
    st = main_path.streamed_sketch(KEY, src, STREAM_P, device="cuda")
    assert torch.equal(st.y, proj.sketch(KEY, a, STREAM_P, method="shgemm_fused"))
    ext = st.widen(9)
    for off, t in stream.offset_tiles(src, device="cuda"):
        stream.update(ext, t, off)
    grown = stream.hstack(st, ext)
    assert torch.equal(grown.y, proj.sketch(KEY, a, STREAM_P + 9,
                                            method="shgemm_fused"))


def test_streamed_left_sketch_matches_plain(gen):
    from repro_torch import main_path, stream
    a = _a(gen, 1000, STREAM_N)
    st = main_path.streamed_sketch(KEY, stream.ArraySource(a, 320), STREAM_P,
                                   left=True, device="cuda")
    want = k2.shgemm_fused_plain(a.T, st.key_psi, st.l).T
    torch.testing.assert_close(st.w, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_tiles_equal_the_hosts(gen, tmp_path, depth):
    """The pinned-buffer prefetch hands over CUDA tiles equal to the host's,
    in order, ragged last tile and all, from numpy and from a memmap."""
    import numpy as np
    from repro_torch import stream
    host = np.random.default_rng(depth).standard_normal((1000, 96)).astype(np.float32)
    np.save(tmp_path / "a.npy", host)
    for src in (stream.ArraySource(host, 128), stream.MemmapSource(tmp_path / "a.npy", 128)):
        tiles = list(stream.prefetch(src.tiles(), depth=depth, device="cuda"))
        assert all(t.device.type == "cuda" for t in tiles)
        assert [t.shape[0] for t in tiles] == [128] * 7 + [104]
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(tiles).cpu(), torch.from_numpy(host))


def test_streamed_rsvd_launches_kernels(gen):
    """rsvd_streamed runs kernel 2 (shgemm_fused) or kernel 1
    (shgemm_pallas) once per row tile of the sketch pass, and matches the
    one-shot rsvd's singular values."""
    from repro_torch import stream
    from repro_torch.core import rsvd
    a = _a(gen, 1024, 512)
    for method, counter in (("shgemm_fused", k2), ("shgemm_pallas", k1)):
        before = counter.launches
        res = rsvd.rsvd_streamed(KEY, stream.ArraySource(a, 256), 16, method=method)
        assert counter.launches - before == 4
        want = rsvd.rsvd(KEY, a, 16, method=method)
        torch.testing.assert_close(res.s, want.s, rtol=1e-4, atol=1e-6 * float(want.s[0]))


# ---------------------------------------------------------------------------
# Checkpointed, resumed streamed jobs on the card (stream.resilience)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fail_at", [3, 8 + 5], ids=["sketch", "B"])
def test_checkpointed_kernel2_job_resumes_bitwise(gen, tmp_path, fail_at):
    """A checkpointed kernel-2 rsvd_streamed (1024 x 512 in 8 tiles, rank
    32) raises a fault in its sketch or B pass and resumes bit for bit
    against the uninterrupted run, through kernel 2."""
    from repro_torch import main_path, stream
    from repro_torch.core import rsvd
    a = _a(gen, 1024, 512)
    src = stream.ArraySource(a, 128)

    def job(s, **kw):
        return rsvd.rsvd_streamed(KEY, s, 32, method="shgemm_fused", **kw)
    want = job(src)
    before = k2.launches
    got, rep = main_path.resume_after_fault(job, src, fail_at_tile=fail_at,
                                            checkpoint_dir=tmp_path,
                                            checkpoint_every_tiles=2)
    assert k2.launches > before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert rep.attempts == 2 and rep.tiles_recomputed <= 2


def test_checkpoint_of_card_state_is_not_torn(gen, tmp_path):
    """commit copies a card state to the host before the writer thread runs:
    updates after the commit leave the checkpoint on disk unchanged."""
    import numpy as np
    from repro_torch import stream
    from repro_torch.stream import resilience as resil
    st = stream.init(KEY, 512, 32, max_rows=256, left=True,
                     method="shgemm_fused")
    stream.update(st, _a(gen, 128, 512), 0)
    before = (st.y.cpu().numpy().copy(), st.w.cpu().numpy().copy())
    ck = resil.SketchJobCheckpointer(tmp_path, every_tiles=1)
    ck.commit(phase="sketch", pass_idx=1, tiles_done=1, rows_done=128,
              payload=lambda: resil.state_to_payload(st))
    stream.update(st, _a(gen, 128, 512), 128)
    st.y.fill_(7.0)
    ck.wait()
    saved = sorted(tmp_path.glob("ckpt_*"))[-1]
    assert np.array_equal(np.load(saved / "state.y.npy"), before[0])
    assert np.array_equal(np.load(saved / "state.w.npy"), before[1])


# -- the autotuner and the distributed path --------------------------------

@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune as at
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    at.forget_picks()
    yield str(path)
    at.forget_picks()


@pytest.mark.parametrize("fused", [False, True], ids=["kernel1", "kernel2"])
@pytest.mark.parametrize("shape", [(300, 130, 700), (64, 32, 8192)], ids=str)
def test_autotuned_plan_is_bit_identical_to_the_planners(gen, tune_cache, fused,
                                                         shape):
    """Every candidate plan (bm, bn, splits) at the planner's bk gives the
    planner's bits, so the tuned one the ops entry serves does too."""
    from repro_torch.kernels import autotune as at
    m, n, k = shape
    a = _a(gen, m, k)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    plan, hit = at.autotune_blocks(m, n, k, fused=fused)
    assert not hit and at.pick_blocks(m, n, k, fused=fused) == plan
    assert at.autotune_blocks(m, n, k, fused=fused) == (plan, True)
    planned = at.planned_blocks(m, n, k, fused=fused)

    def run(p=None):
        kw = {} if p is None else dict(blocks=p[:3], splits=p[3])
        return (ops.shgemm_fused(a, KEY, n, **kw) if fused
                else ops.shgemm(a, b, **kw))
    want = run(planned)
    assert torch.equal(run(), want)
    for cand in at.candidate_blocks(m, n, k, fused=fused):
        assert torch.equal(run(cand), want), cand


def test_autotuned_decode_split_matches_plain(gen, tune_cache):
    from repro_torch.kernels import autotune as at
    b, kvh, s, g, hd, r = 2, 2, 512, 2, 64, 8
    p, hit = at.autotune_decode_block(b, kvh, s, g, hd, r)
    assert not hit and p in at.candidate_decode_blocks(b, kvh, s, g, hd, r)
    assert at.pick_decode_block(b, kvh, s, g, hd, r) == p
    comp = torch.tensor([100, 0], dtype=torch.int32, device="cuda")
    q = torch.randn((b, 1, g * kvh, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    us_k, us_v = (torch.randn((b, kvh, s, r), generator=gen, device="cuda")
                  for _ in range(2))
    vt_k, vt_v = (torch.randn((b, kvh, r, hd), generator=gen, device="cuda")
                  for _ in range(2))
    args = (q, k, v, us_k, vt_k, us_v, vt_v, comp, 300)
    before = k4.launches
    got = ops.factored_decode_attention(*args, scale=hd ** -0.5)
    assert k4.launches == before + 1
    want = k4.factored_decode_plain(*args, scale=hd ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_gloo_world_on_one_card_merges_bitwise(gen):
    """Two gloo ranks on CUDA tensors: merge_across_hosts of disjoint rows
    equals the one-process sketch bit for bit, and a key mismatch poisons."""
    import numpy as np
    from repro_torch import stream
    from repro_torch.launch import world
    a = np.random.default_rng(0).standard_normal((128, 96)).astype(np.float32)
    outs = world.run_world("torch_dist_workers:merge_case", 2, device="cuda",
                           kwargs=dict(a=a, split=[(0, 64, 24), (64, 128, 32)],
                                       p_hat=22, psi_words=(5, 7), bad_key=(0, 9)),
                           timeout=120)
    one = ops.shgemm_fused(torch.from_numpy(a).cuda(), (0, 0), 22).cpu().numpy()
    for out in outs:
        assert np.array_equal(out["y"], one)
        assert out["rows_seen"] == 128
        assert np.isnan(out["poisoned_y"]).all()


def test_nccl_world_merges_bitwise(gen):
    """NCCL puts one rank on each card: needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards for two NCCL ranks")
    import numpy as np
    from repro_torch.launch import world
    a = np.random.default_rng(0).standard_normal((128, 96)).astype(np.float32)
    outs = world.run_world("torch_dist_workers:merge_case", 2, backend="nccl",
                           device="cuda",
                           kwargs=dict(a=a, split=[(0, 64, 24), (64, 128, 32)],
                                       p_hat=22, psi_words=(5, 7), bad_key=(0, 9)),
                           timeout=120)
    one = ops.shgemm_fused(torch.from_numpy(a).cuda(), (0, 0), 22).cpu().numpy()
    assert all(np.array_equal(out["y"], one) for out in outs)


@pytest.mark.parametrize("method", ["shgemm_pallas", "shgemm_fused"])
def test_nccl_world_distributed_rsvd(gen, method):
    """A 2 x 2 NCCL world, a card a rank: distributed_rsvd through kernel 1
    or 2 within the one-process rSVD's limit (1.5x f32 + 1e-7) and its
    singular values (rtol 1e-2)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards for a 2 x 2 NCCL world")
    from repro_torch.core import rsvd
    from repro_torch.launch import world
    n, rank_k = 1024, 64
    a = rsvd.matrix_with_singular_values(
        gen, n, rsvd.singular_values_exp(n, rank_k, 1e-4))
    outs = world.run_world("torch_dist_workers:rsvd_case", 4, backend="nccl",
                           device="cuda",
                           kwargs=dict(sizes=(2, 2), a=a.cpu().numpy(),
                                       rank_k=rank_k, method=method),
                           timeout=180)
    one = rsvd.rsvd((0, 1), a, rank_k, method=method)
    f32 = rsvd.rsvd((0, 1), a, rank_k, method="f32")
    limit = 1.5 * float(rsvd.reconstruction_error(a, f32)) + 1e-7
    for out in outs:
        assert out["err"] <= limit
        torch.testing.assert_close(torch.from_numpy(out["s"])[:16],
                                   one.s[:16].cpu(), rtol=1e-2, atol=0)


# ---------------------------------------------------------------------------
# The training slice: GaLore's range finder and gradient compression through
# kernels 1-2, the train step on the card
# ---------------------------------------------------------------------------

def _grads(shapes, seed, device):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g).to(device) for k, s in shapes.items()}


@pytest.mark.parametrize("method", ["shgemm_pallas", "shgemm_fused"])
def test_galore_kernel_updates_match_plain(gen, method):
    """Three GaLore steps (rank 16, refreshes at 1 and 3) on the card
    through the kernel against the CPU's plain version of the same method:
    ||update - plain|| / ||plain|| <= 1e-4 per leaf, the kernel launched."""
    from repro_torch.optim import galore
    shapes = {"tall": (512, 96), "wide": (64, 300), "b": (64,)}
    tx = galore.galore(1e-2, rank=16, refresh_every=2, method=method)
    counter = k2 if method == "shgemm_fused" else k1
    before = counter.launches
    params = {dev: _grads(shapes, 0, dev) for dev in ("cuda", "cpu")}
    states = {dev: tx.init(params[dev]) for dev in params}
    for step in range(3):
        ups = {}
        for dev in params:
            ups[dev], states[dev] = tx.update(_grads(shapes, 10 + step, dev),
                                              states[dev], params[dev])
        for k in shapes:
            want = ups["cpu"][k]
            rel = (ups["cuda"][k].cpu() - want).norm() / want.norm()
            assert rel <= 1e-4, (step, k, float(rel))
    assert counter.launches >= before + 4       # two matrices, two refreshes


@pytest.mark.parametrize("method", ["shgemm_pallas", "shgemm_fused"])
def test_compression_kernel_matches_plain(gen, method, monkeypatch):
    """compress_and_reduce on the card (kernel 1 on Q) against the CPU's
    plain version on the same basis Q (bf16 rounds Q, so two QRs' 1e-7
    differences would round some of it the other way): rtol 1e-4, atol
    1e-4; the incompressible leaf bit for bit."""
    from repro_torch.optim import compression
    shapes = {"w": (1000, 96), "b": (96,)}
    real = compression._draw_basis
    bases = {}

    def shared(key, i, d, rank, m, device):
        if (key, i) not in bases:
            bases[(key, i)] = real(key, i, d, rank, m, "cpu")
        return bases[(key, i)].to(device)

    monkeypatch.setattr(compression, "_draw_basis", shared)
    grads = {dev: _grads(shapes, 3, dev) for dev in ("cpu", "cuda")}
    st = {dev: compression.init_state(grads[dev]) for dev in grads}
    before = k1.launches
    for _ in range(2):
        out = {}
        for dev in ("cpu", "cuda"):
            out[dev], st[dev] = compression.compress_and_reduce(
                grads[dev], st[dev], rank=32, method=method)
        torch.testing.assert_close(out["cuda"]["w"].cpu(), out["cpu"]["w"],
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(out["cuda"]["b"].cpu(), out["cpu"]["b"])
    assert k1.launches == before + 2


@pytest.mark.parametrize("optimizer", ["adamw", "galore"])
def test_train_step_on_card_matches_cpu(gen, optimizer):
    """Two steps of the smoke qwen3 train step in f32 activations on the
    card against the CPU: losses at rel 1e-5, params at atol 1e-5; GaLore's
    range finder runs kernel 2."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import galore
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4)
    tx = (galore.galore(1e-3, rank=16, refresh_every=2, method="shgemm_fused")
          if optimizer == "galore" else "adamw")
    step = R.make_train_step(cfg, optimizer=tx, micro_batches=2)
    out = {}
    before = k2.launches
    for dev in ("cpu", "cuda"):
        p = launch.init_weights(cfg, seed=0, device="cpu")
        p = {k: v.to(dev) for k, v in p.items()}
        s = step.init_opt(p)
        losses = []
        for i in range(2):
            p, s, m = step(p, s, data.batch(i))
            losses.append(float(m["loss"]))
        out[dev] = (p, losses)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-5)
    for k, v in out["cpu"][0].items():
        torch.testing.assert_close(out["cuda"][0][k].cpu(), v, rtol=0, atol=1e-5)
    if optimizer == "galore":
        assert k2.launches > before


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_moe_block_on_card_matches_cpu(gen, act):
    """The smoke qwen3-moe layer's routed experts (64 tokens, capacity 20:
    pairs drop) on the card against the CPU: equal routed sets, outputs at
    rtol 1e-5 / atol 1e-6 in f32 and 2e-2 / 2e-3 in bf16, and two card
    calls bit for bit (the combine adds in a fixed order, no atomics)."""
    from repro_torch.models import moe
    cfg = smoke_config(R.get_arch("qwen3-moe-30b-a3b")).with_(activation_dtype=act)
    dt = getattr(torch, act)
    p = {k[len("layers/p0/"):]: v[0]
         for k, v in launch.init_weights(cfg, seed=0, device="cpu").items()
         if k.startswith("layers/p0/moe/")}
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x = (x * 8).to(dt)                    # decisive routing at init's scale
    want = moe.moe_block(cfg, p, x)
    pc = {k: v.cuda() for k, v in p.items()}
    got = moe.moe_block(cfg, pc, x.cuda())
    assert torch.equal(moe.moe_block(cfg, pc, x.cuda()), got)
    sets = [torch.sort(moe.route(cfg, x.to(d).reshape(-1, cfg.d_model).float()
                                 @ p["moe/router"].to(d))[1], -1).values.cpu()
            for d in ("cpu", "cuda")]
    assert torch.equal(sets[0], sets[1])
    tol = dict(rtol=1e-5, atol=1e-6) if act == "float32" else dict(rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(got.cpu(), want, **tol)


def _mla_layer(cfg):
    """The smoke deepseek's prelude MLA leaves, scaled up so that the
    attention is far from uniform."""
    return {k[len("pre0/"):]: v * (1.0 if k.endswith("kv_norm") else 10.0)
            for k, v in launch.init_weights(cfg, seed=0, device="cpu").items()
            if k.startswith("pre0/mla/")}


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_mla_cached_branch_on_card_matches_cpu(gen, act, chunk):
    """MLA's cached branch on the card against the CPU: 16 tokens at
    positions 4..19 of a 24-row bf16 latent cache, in chunks of ``chunk``
    rows (1: the absorbed decode step), outputs at rtol 1e-5 / atol 1e-5
    in f32 and 2e-2 / 2e-2 in bf16, the written cache rows alike."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla
    cfg = smoke_config(R.get_arch("deepseek-v2-lite-16b")).with_(activation_dtype=act)
    m, dt = cfg.mla, getattr(torch, act)
    p = _mla_layer(cfg)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 16, cfg.d_model), generator=g).to(dt)
    cache0 = {"ckv": torch.randn((2, 24, m.kv_lora_rank), generator=g),
              "kr": torch.randn((2, 24, m.qk_rope_dim), generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev) for k, v in p.items()}
        cache = {k: v.to(dev, torch.bfloat16) for k, v in cache0.items()}
        for v in cache.values():
            v[:, 4:] = 0
        outs = []
        for start in range(0, 16, chunk):
            end = min(start + chunk, 16)
            pos = torch.arange(4 + start, 4 + end, device=dev)
            o, _ = mla.mla_block(cfg, pd, x[:, start:end].to(dev), positions=pos,
                                 rope=L.rope_tables(pos, m.qk_rope_dim, cfg.rope_theta),
                                 cache=cache, write_pos=4 + start, return_cache=False)
            outs.append(o)
        out[dev] = (torch.cat(outs, dim=1), cache)
    tol = dict(rtol=1e-5, atol=1e-5) if act == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], **tol)
    for name in ("ckv", "kr"):
        torch.testing.assert_close(out["cuda"][1][name].float().cpu(),
                                   out["cpu"][1][name].float(), rtol=1e-2, atol=1e-2)


def test_deepseek_prefill_and_decode_on_card_match_cpu(gen):
    """The smoke deepseek-v2-lite in f32 with ``use_flash_kernel`` set:
    make_prefill_step (MLA materialized) and one absorbed decode step on the
    card against the CPU at 1e-4; the MLA layers launch no kernel 3."""
    cfg = smoke_config(R.get_arch("deepseek-v2-lite-16b")).with_(
        activation_dtype="float32", use_flash_kernel=True)
    params = launch.init_weights(cfg, seed=0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 13), generator=torch.Generator().manual_seed(3))
    from repro_torch.models import cache as C
    out = {}
    before = k3.launches
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        pre, cache = R.make_prefill_step(cfg)(p, {"tokens": tok[:, :12].to(dev)})
        dec, _ = R.make_serve_step(cfg)(p, {"tokens": tok[:, 12:].to(dev),
                                            "cache": C.grow_cache(cache, 1, cfg),
                                            "write_pos": 12})
        out[dev] = (pre.cpu(), dec.cpu())
    assert k3.launches == before
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["rglru", "mlstm", "slstm"])
def test_recurrent_block_on_card_matches_cpu(gen, mixer, act):
    """Each recurrent mixer on the card against the CPU: a 40-token chunk
    from a random cached state (mLSTM in chunks of 16), then one token,
    outputs and the states written into the cache at rtol 1e-5 / atol 1e-5
    in f32 and 2e-2 / 2e-2 in bf16."""
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as T
    arch = "recurrentgemma-2b" if mixer == "rglru" else "xlstm-350m"
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype=act)
    spec = next(sp for sp in cfg.pattern if sp.mixer == mixer)
    g = torch.Generator().manual_seed(4)
    prefix = "rnn/" if mixer == "rglru" else f"{mixer}/"
    p = {k: d.scale * torch.randn(d.shape, generator=g)
         for k, d in T._layer_defs(cfg, spec).items() if k.startswith(prefix)}
    dt = getattr(torch, act)
    x = torch.randn((2, 41, cfg.d_model), generator=g).to(dt)
    _, state0 = getattr(rec, f"{mixer}_block")(cfg, p, x[:, :8], cache=None,
                                               return_cache=True)
    block = getattr(rec, f"{mixer}_block")
    kw = {"chunk": 16} if mixer == "mlstm" else {}
    out = {}
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev) for k, v in p.items()}
        cache = {k: v.to(dev).clone() for k, v in state0.items()}
        o1, _ = block(cfg, pd, x[:, 8:40].to(dev), cache=cache, return_cache=False, **kw)
        o2, _ = block(cfg, pd, x[:, 40:].to(dev), cache=cache, return_cache=False)
        out[dev] = (o1.cpu(), o2.cpu(), {k: v.cpu() for k, v in cache.items()})
    tol = dict(rtol=1e-5, atol=1e-5) if act == "float32" else dict(rtol=2e-2, atol=2e-2)
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(got, want, **tol)
    for k, v in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][k], v, **tol)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_recurrent_masked_step_on_card_keeps_other_slots(gen, arch):
    """ModelStep on the card (bf16): chunked prefill into three slots, a
    masked decode step for slot 0 leaves slots 1 and 2's state bit for
    bit, and begin_slot zeroes a slot's state."""
    from repro_torch.serve.model_step import ModelStep
    cfg = smoke_config(R.get_arch(arch))
    params = launch.init_weights(cfg, seed=0, device="cuda")
    m = ModelStep(cfg, params, slots=3, max_seq=32, device="cuda")
    for slot, n in ((0, 6), (1, 9), (2, 4)):
        m.prefill_rows(slot, list(range(1, n + 1)), 0)

    def rows(slot):
        return [(leaf[:, slot] if g == "scan" else leaf[slot]).clone()
                for g, leaf in m._state_leaves()]
    before = [rows(s) for s in range(3)]
    m.decode_logits([[5], [6], [7]], 9, slot_mask=[True, False, False])
    for s in (1, 2):
        assert all(torch.equal(a, b) for a, b in zip(rows(s), before[s]))
    assert not all(torch.equal(a, b) for a, b in zip(rows(0), before[0]))
    m.begin_slot(1)
    assert all(not r.any() for r in rows(1))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_encdec_vlm_prefill_and_decode_on_card_match_cpu(gen, arch):
    """make_prefill_step with the stub frontends' embeddings (whisper's
    encoder over frame embeddings, llava's projected image rows; kernel 3
    on the card's decoder layers, its plain version on the CPU), then one
    decode step on the grown cache: f32, card against CPU at 1e-4."""
    from repro_torch.models import cache as C
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype="float32",
                                               use_flash_kernel=True)
    params = launch.init_weights(cfg, seed=0, device="cpu")
    extra = launch.stub_embeds(cfg, 2, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 13), generator=torch.Generator().manual_seed(3))
    n_img = cfg.vlm.num_image_tokens if cfg.vlm else 0
    out = {}
    before = k3.launches
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        pre, cache = launch.run_prefill(cfg, p, tok[:, :12].to(dev),
                                        **{k: v.to(dev) for k, v in extra.items()})
        dec, _ = R.make_serve_step(cfg)(p, {"tokens": tok[:, 12:].to(dev),
                                            "cache": C.grow_cache(cache, 1, cfg),
                                            "write_pos": 12 + n_img})
        out[dev] = (pre.cpu(), dec.cpu())
    assert k3.launches == before + cfg.n_layers
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Training and serving across processes: gloo worlds on the one card
# ---------------------------------------------------------------------------

def test_gloo_reduces_bf16_cuda_tensors(gen):
    """gloo's all-reduce and all-gather take bf16 tensors on the card (the
    mesh branches' psums and gathers run in the activation dtype)."""
    from repro_torch.launch import world
    outs = world.run_world("torch_shard_workers:gloo_dtypes_case", 2,
                           device="cuda", timeout=120)
    for out in outs:
        for dt, (red, parts) in out.items():
            assert red.tolist() == [4.0] * 5, dt
            assert [p.tolist() for p in parts] == [[1.5] * 5, [2.5] * 5], dt


def test_sharded_world_on_card_matches_one_process(gen):
    """A (1, 2) gloo world on the card: qwen3-moe's smoke config with the
    vocab-parallel loss and gradients, then the expert-parallel forward
    with kernel 3 on, against one process (f32 activations)."""
    import numpy as np

    from repro_torch.launch import world
    from repro_torch.models import transformer as T
    cfg = smoke_config(R.get_arch("qwen3-moe-30b-a3b")).with_(
        activation_dtype="float32")
    params = {k: v.cpu().numpy() for k, v in T.init_params(
        cfg, torch.Generator().manual_seed(5)).items()}
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=g).numpy()
             for k in ("tokens", "labels")}
    dev_params = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
    want, want_g = R.loss_and_grads(cfg, dev_params, batch)
    outs = world.run_world("torch_shard_workers:loss_grads_case", 2,
                           device="cuda", timeout=180,
                           kwargs=dict(sizes=(1, 2), arch="qwen3-moe-30b-a3b",
                                       act="float32", params=params,
                                       batch=batch))
    loss, grads = outs[0]
    assert loss == pytest.approx(float(want), rel=2e-5)
    for k, w in want_g.items():
        w = w.cpu().numpy()
        assert np.abs(grads[k] - w).max() <= 2e-2 * np.abs(w).max() + 1e-12, k
    kcfg = cfg.with_(use_flash_kernel=True)
    tok = torch.from_numpy(batch["tokens"]).cuda()
    with torch.no_grad():
        one = T.forward(kcfg, T.cast_params_for_compute(kcfg, dev_params),
                        tok).logits.float().cpu().numpy()
    outs = world.run_world("torch_shard_workers:forward_case", 2,
                           device="cuda", timeout=180,
                           kwargs=dict(sizes=(1, 2), arch="qwen3-moe-30b-a3b",
                                       act="float32", params=params,
                                       tokens=batch["tokens"], flash=True))
    for out in outs:
        assert out["launches"] == cfg.n_layers
        np.testing.assert_allclose(out["logits"], one, rtol=1e-5, atol=1e-5)


def test_init_weights_mesh_slices_on_card(gen):
    """``init_weights(mesh=)`` on the card: each rank's leaves bit for bit
    its blocks of the one-process draw from the same CUDA generator."""
    from repro_torch.launch import world
    cfg = smoke_config(R.get_arch("qwen3-moe-30b-a3b"))
    whole = launch.init_weights(cfg, seed=3, device="cuda", compute_dtype=True)
    outs = world.run_world("torch_shard_workers:init_case", 2, device="cuda",
                           timeout=120,
                           kwargs=dict(sizes=(1, 2), arch="qwen3-moe-30b-a3b",
                                       compute_dtype=True, serving=True, seed=3))
    for out in outs:
        m = out["index"][1]
        for k, w in whole.items():
            for dim, entry in enumerate(out["specs"][k]):
                if entry == "model":
                    n = w.shape[dim] // 2
                    w = w.narrow(dim, m * n, n)
            w = w.contiguous().cpu()
            if w.dtype == torch.bfloat16:
                w = w.view(torch.int16)
            assert (out["w"][k] == w.numpy()).all(), k


def test_sharded_save_holds_only_its_slices_on_the_card(gen):
    """A collective checkpoint save in a (2, 2) gloo world on the card
    (f32 masters and AdamW state): no rank's peak device memory grows by
    more than its largest slice, where gathering every leaf whole would
    add four times its state."""
    from repro_torch.launch import world
    outs = world.run_world("torch_shard_workers:save_peak_case", 4,
                           device="cuda", timeout=180,
                           kwargs=dict(sizes=(2, 2), arch="qwen3-0.6b"))
    for out in outs:
        assert out["grew"] <= out["largest"], out


# -- the cell machinery and the dry run ------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(R.ARCHS))
def test_materialize_inputs_and_step_for_on_card(gen, arch, kind):
    """``materialize_inputs`` lands on the card by default (the same seed
    the same bits, ids in [0, vocab)), and the cell's ``step_for`` step runs
    there on the smoke config: finite outputs of the cell's shapes."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import transformer as T
    cfg = smoke_config(R.get_arch(arch))
    shape = ShapeCfg("s", kind, 16 if kind == "decode" else 32, 2)
    batch = R.materialize_inputs(cfg, shape, 1)
    again = R.materialize_inputs(cfg, shape, 1)
    for k in ("tokens", "write_pos"):
        if k in batch:
            assert batch[k].device.type == "cuda" and torch.equal(batch[k], again[k])
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab
    params = T.init_params(cfg, gen)
    step = R.step_for(cfg, shape)
    if kind == "train":
        _, _, m = step(params, step.init_opt(params), batch)
        assert math.isfinite(float(m["loss"])) and float(m["loss"]) > 0
        return
    with torch.no_grad():
        logits, _ = step(params, batch)
    assert tuple(logits.shape) == (2, cfg.vocab) and bool(torch.isfinite(logits).all())


def test_dryrun_argument_bytes_are_the_cards_tensors(gen):
    """A (1, 1) dry run of the smoke qwen3 prefill: its argument bytes are
    the bytes of the weights and inputs the same step holds on the card,
    and its matmul FLOPs FlopCounterMode's on the card's run."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import transformer as T
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    shape = ShapeCfg("s", "prefill", 32, 2)
    row = DR.run_cell(cfg, shape, HostMesh((1, 1)), probe=False)
    params = T.init_params(cfg, gen)
    batch = R.materialize_inputs(cfg, shape, 0)
    held = sum(t.numel() * t.element_size()
               for t in list(params.values()) + list(batch.values()))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        R.step_for(cfg, shape)(params, batch)
    assert row["memory"]["argument_bytes"] == held
    assert row["flops"] == fc.get_total_flops()


def test_poisoned_launches_leave_no_nan_and_equal_a_normal_launch(gen):
    """The launch audit held against the kernels: each kernel's output (and
    workspace) filled with NaN first — kernels 1 and 2 with 4 splits,
    kernel 3 at G 7 causal, kernel 4 with P 4 — keeps no NaN where its
    ``launch_grid`` says it writes, and equals a normal launch bit for
    bit."""
    from repro_torch.analysis.launch_audit import poisoned_launches
    res = poisoned_launches("cuda")
    for name, r in res.items():
        assert r["nan_out"] == 0 and r["nan_workspace"] == 0, (name, r)
        assert r["bitwise"] and r["into_out"] and r["launches"] == 1, (name, r)


def test_dispatch_contracts_clean_on_card(gen):
    """The dispatch-mode contracts with their inputs on the card: the
    kernels launch through ctypes there, and the SRHT path launches none."""
    from repro_torch.analysis import findings as F
    from repro_torch.analysis.contracts import run_repo_contracts
    got = run_repo_contracts(["srht-no-gemm", "sketch-dtype-flow",
                              "stream-update-dtype-flow", "sketch-determinism",
                              "stream-b-weak-audit"], device="cuda")
    assert got == [], F.render_text(got)
