"""The yardstick's frozen copies agree with the program's code they were
copied from, at small sizes on the CPU (and the lattice with kernel 2's
own Omega on the card)."""

import pytest
import torch

from bench import inputs, lattice
from repro_torch.core import hosvd as port_hosvd
from repro_torch.core import rsvd as port_rsvd
from repro_torch.kernels import shgemm_fused

KEYS = [(0, 0), (7, 2**31 + 5), lattice.call_key(2**33 + 17, 123)]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_lattice_matches_reference_omega(key, dtype):
    want = shgemm_fused.reference_omega(key, (300, 70), dtype=dtype,
                                        device="cpu").to(torch.float32)
    got = lattice.gaussian(key, (300, 70), dtype=dtype, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("key", KEYS)
def test_mode_keys_match(key):
    assert lattice.mode_keys(key, 3) == port_hosvd._mode_keys(key, 3)


def test_call_keys_differ_and_repeat():
    keys = [lattice.call_key(2**31 + 11, i) for i in range(1000)]
    assert len(set(keys)) == 1000
    assert keys == [lattice.call_key(2**31 + 11, i) for i in range(1000)]
    assert all(0 <= w < 2**32 for k in keys for w in k)


def test_a_exp_matches_port():
    n, p, s_p = 96, 12, 1e-4
    got = inputs.a_exp(torch.Generator().manual_seed(5), n, p, s_p)
    gen = torch.Generator().manual_seed(5)
    want = port_rsvd.matrix_with_singular_values(
        gen, n, port_rsvd.singular_values_exp(n, p, s_p, device="cpu"))
    assert torch.equal(got, want)


def test_algorithm3_matches_port():
    dims, ranks = (24, 20, 16), (6, 5, 4)
    got = inputs.algorithm3(torch.Generator().manual_seed(9), dims, ranks, 2)
    want = port_hosvd.make_test_tensor(torch.Generator().manual_seed(9),
                                       dims, ranks, 2)
    assert torch.equal(got, want)


def test_pool_repeats_from_seed():
    config = {"input": "algorithm3", "dims": [16, 16, 16],
              "ranks": [2, 2, 2], "pad": 1, "pool": 2}
    a = inputs.make_pool(config, 2**32 + 3, "cpu")
    b = inputs.make_pool(config, 2**32 + 3, "cpu")
    assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert inputs.hosvd_ranks({"dims": [256] * 3, "ranks": [32] * 3}) \
        == [32, 32, 32]
    with pytest.raises(ValueError):
        inputs.hosvd_ranks({"dims": [256] * 3, "ranks": [32] * 2})


@pytest.mark.cuda
def test_lattice_matches_kernel2_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops
    key = lattice.call_key(2**31 + 99, 4)
    got = ops.chip_omega(key, 4096, 266, device="cuda").to(torch.float32)
    want = lattice.gaussian(key, (4096, 266), device="cuda")
    # the card's logf / cosf against the host's: equal to a bf16 rounding
    # here and there
    assert (got != want).float().mean() < 1e-3
    assert torch.max(torch.abs(got - want)) <= 2**-7 * torch.max(torch.abs(want))
