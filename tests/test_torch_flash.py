"""Kernel 3's plain version (repro_torch.kernels.flash_attention) against the
reference's oracle ``flash_attention_ref`` and its Pallas kernel in
interpret mode, on the same numpy inputs, at the shapes of the reference's
tests/test_flash_attention.py: bf16 at rtol 2e-2 / atol 3e-2, f32 at 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels.flash_attention import flash_attention as ref_kernel
from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro_torch.convert import from_reference
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=3e-2)


def _qkv(seed, b, s, h, kvh, hd, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(dtype)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]
    return arrs, [from_reference(np.asarray(a)) for a in arrs]


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,s,h,kvh,hd,bq,bkv", [
    (2, 256, 8, 4, 64, 64, 64),     # GQA 2:1
    (1, 512, 4, 1, 128, 128, 256),  # MQA, rectangular blocks
    (2, 128, 4, 4, 32, 64, 32),     # MHA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel_and_oracle(b, s, h, kvh, hd, bq, bkv,
                                                   causal):
    (qj, kj, vj), (q, k, v) = _qkv(b * s + h, b, s, h, kvh, hd)
    got = k3.flash_attention(q, k, v, causal=causal)       # CPU: plain version
    want_k = ref_kernel(qj, kj, vj, causal=causal, block_q=bq, block_kv=bkv,
                        interpret=True)
    want_o = ref_oracle(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want_k), **BF16_TOL)
    np.testing.assert_allclose(_f32(got), _f32(want_o), **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_port_oracle_matches_reference_oracle(causal):
    (qj, kj, vj), (q, k, v) = _qkv(3, 2, 64, 4, 2, 32, dtype=jnp.float32)
    np.testing.assert_allclose(_f32(flash_attention_ref(q, k, v, causal=causal)),
                               _f32(ref_oracle(qj, kj, vj, causal=causal)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ops_wrapper_ragged(causal):
    """S = 200 is not a block multiple: the reference wrapper pads (or, for
    non-causal, takes its oracle); the port's kernel masks the edge."""
    (qj, kj, vj), (q, k, v) = _qkv(7, 2, 200, 4, 2, 64)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = rops.flash_attention(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


def test_f32_inputs():
    (qj, kj, vj), (q, k, v) = _qkv(9, 1, 128, 4, 4, 64, dtype=jnp.float32)
    got = k3.flash_attention(q, k, v, causal=True)
    want = ref_kernel(qj, kj, vj, causal=True, block_q=64, block_kv=64,
                      interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [7, 64, 1024])
def test_plain_chunking_is_invisible(chunk):
    """The plain version's query chunk only bounds memory."""
    _, (q, k, v) = _qkv(11, 1, 100, 4, 2, 16, dtype=jnp.float32)
    np.testing.assert_allclose(
        _f32(k3.flash_attention_plain(q, k, v, causal=True, chunk=chunk)),
        _f32(flash_attention_ref(q, k, v, causal=True)), rtol=1e-5, atol=1e-5)


def test_causal_flops_counts_the_lower_triangle():
    """The bound counts the pairs at or below the diagonal: s(s+1)/2."""
    assert k3.causal_flops(1, 4, 1, 1) == 2 * 2 * 10
    full = 2 * 2 * 32768 * 32768 * 16 * 128
    assert k3.causal_flops(1, 32768, 16, 128) == pytest.approx(full / 2, rel=1e-4)


def test_kernel_wrapper_raises_for_non_cpu_non_cuda_tensor():
    q = torch.empty((1, 16, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k3.flash_attention(q, q[:, :, :2], q[:, :, :2])


def test_shape_mismatch_raises():
    q, k = torch.zeros((1, 16, 4, 16)), torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        k3.flash_attention(q, k, k)
