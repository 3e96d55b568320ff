"""Port vs reference: the f32 mantissa splits (core/splitting.py) are chains
of RN casts and exact f32 subtractions, so they must agree bit for bit —
values past fp16 range (inf), subnormals and signed zeros included.

XLA's CPU backend runs with subnormals flushed to zero (inputs and results),
so the port is compared under the same floating-point environment
(``torch.set_flush_denormal(True)`` for the duration of each test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import splitting as ref_split
from repro_torch.convert import from_reference
from repro_torch.core import splitting as port_split

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers


def _inputs() -> np.ndarray:
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1e-40, -3e-39, 1e-45, 6e-8, 65504.0,
                        65519.0, 65520.0, -7e4, 1e5, 3.0e38, -1.7e38,
                        1.0 + 2.0**-20, 2.0**-14, 2.0**-24], np.float32)
    normal = rng.standard_normal(2000).astype(np.float32)
    wide = (rng.standard_normal(2000) * 10.0 ** rng.uniform(-30, 30, 2000))
    return np.concatenate([special, normal, wide.astype(np.float32)])


def assert_bitwise(want, got: torch.Tensor):
    """Same dtype and same bits everywhere, except that NaNs need only share
    positions (their payloads are the platform's)."""
    want = np.asarray(want)
    assert str(got.dtype) == "torch." + want.dtype.name, (got.dtype, want.dtype)
    size = want.dtype.itemsize
    want_bits = want.view({2: np.uint16, 4: np.uint32}[size])
    got_bits = (got.contiguous().view({2: torch.int16, 4: torch.int32}[size])
                .numpy().view(want_bits.dtype))
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(nan, torch.isnan(got.float()).numpy())
    np.testing.assert_array_equal(want_bits[~nan], got_bits[~nan])


@pytest.fixture(autouse=True)
def flush_denormals_like_xla_cpu():
    assert torch.set_flush_denormal(True), "CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


SPLITS = {
    "split_fp32_bf16": lambda m, a: m.split_fp32_bf16(a),
    "split_fp32_fp16": lambda m, a: m.split_fp32_fp16(a),
    "split_fp32_bf16_3": lambda m, a: m.split_fp32_bf16_3(a),
    "split_fp32[bf16]": lambda m, a: m.split_fp32(a, "bf16"),
    "split_fp32[fp16]": lambda m, a: m.split_fp32(a, "fp16"),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_bitwise(name):
    x = _inputs()
    want = SPLITS[name](ref_split, jnp.asarray(x))
    got = SPLITS[name](port_split, torch.from_numpy(x))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert_bitwise(w, g)


@pytest.mark.parametrize("fmt", ["bf16", "fp16"])
def test_merge_split_bitwise(fmt):
    x = _inputs()
    hi, lo = ref_split.split_fp32(jnp.asarray(x), fmt)
    want = ref_split.merge_split(hi, lo)
    got = port_split.merge_split(from_reference(np.asarray(hi)),
                                 from_reference(np.asarray(lo)))
    assert got.dtype == torch.float32
    assert_bitwise(want, got)


@pytest.mark.parametrize("fmt", ["bf16", "fp16"])
def test_split_residual_bitwise(fmt):
    x = _inputs()
    want = ref_split.split_residual(jnp.asarray(x), fmt)
    got = port_split.split_residual(torch.from_numpy(x), fmt)
    assert_bitwise(want, got)


def test_fp16_overflow_is_inf_like_the_reference():
    x = np.array([7e4, -1e5, 65519.0], np.float32)
    hi, _ = port_split.split_fp32_fp16(torch.from_numpy(x))
    assert torch.isinf(hi[:2]).all() and hi[2].item() == 65504.0


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown split format"):
        port_split.split_fp32(torch.ones(2), "fp8")
