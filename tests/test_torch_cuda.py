"""The two hand-written kernels against their plain PyTorch versions on the
card.  A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips without a card.  The file imports no JAX (the
machine with the card has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.convert import key_from_seed
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm as k1
from repro_torch.kernels import shgemm_fused as k2

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


def test_kernel_rejects_misaligned_operand(gen):
    a = _a(gen, 64, 65)[:, 1:]  # contiguous rows are not the point: a view
    b = torch.ones((64, 32), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        k1.shgemm_pallas(a, b, bm=32, bn=32, bk=32)
