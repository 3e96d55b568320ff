"""The port's transformer layers (repro_torch.models.layers) against the
reference's (repro.models.layers) on the same numpy inputs: norms,
activations, RoPE, blockwise attention (causal, GQA, windowed, chunked,
softcapped), the projections and the MLP — f32 at 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import smoke_config as ref_smoke
from repro.models import layers as RL
from repro.models import registry as RR
from repro_torch.configs.base import smoke_config
from repro_torch.models import layers as PL
from repro_torch.models import registry as R

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 4, 16)], ids=str)
def test_rmsnorm(shape):
    x, s = _rand(0, *shape), 0.1 * _rand(1, shape[-1])
    _close(PL.rmsnorm(torch.tensor(x), torch.tensor(s), 1e-6),
           RL.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))


def test_rmsnorm_bf16_bitwise():
    x = _rand(2, 4, 64)
    want = RL.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jnp.zeros(64))
    got = PL.rmsnorm(torch.tensor(x).bfloat16(), torch.zeros(64))
    _close(got, np.asarray(want, np.float32), rtol=0, atol=0)


def test_layernorm():
    x, s, b = _rand(3, 4, 32), 0.1 * _rand(4, 32), 0.1 * _rand(5, 32)
    _close(PL.layernorm(torch.tensor(x), torch.tensor(s), torch.tensor(b), 1e-5),
           RL.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_f32(name):
    x = 3 * _rand(6, 4, 64)
    _close(PL.activation(name, torch.tensor(x)), RL.activation(name, jnp.asarray(x)))


def test_silu_bf16_bitwise():
    """The port evaluates x * (1 / (1 + exp(-x))) op by op in bf16, as XLA
    does; a fused silu would round once and differ."""
    x = _rand(7, 8, 64)
    want = RL.activation("silu", jnp.asarray(x).astype(jnp.bfloat16))
    got = PL.activation("silu", torch.tensor(x).bfloat16())
    _close(got, np.asarray(want, np.float32), rtol=0, atol=0)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = 50 * _rand(8, 16)
    _close(PL.softcap(torch.tensor(x), cap), RL.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    x = _rand(9, 2, 7, 3, 16)
    pos = np.arange(7) if not batched else np.stack([np.arange(7), np.arange(3, 10)])
    cr, sr = RL.rope_tables(jnp.asarray(pos), 16, 1e6)
    ct, st = PL.rope_tables(torch.tensor(pos), 16, 1e6)
    _close(ct, cr, rtol=1e-6, atol=1e-6)
    _close(st, sr, rtol=1e-6, atol=1e-6)
    _close(PL.apply_rope(torch.tensor(x), ct, st), RL.apply_rope(jnp.asarray(x), cr, sr))


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)], ids=str)
@pytest.mark.parametrize("causal,window,cap", [
    (True, None, 0.0), (False, None, 0.0), (True, 5, 0.0), (True, None, 20.0)],
    ids=str)
@pytest.mark.parametrize("chunk", [4, 16, 1024])
def test_attention(h, kvh, causal, window, cap, chunk):
    b, s, hd = 2, 16, 8
    q, k, v = _rand(10, b, s, h, hd), _rand(11, b, s, kvh, hd), _rand(12, b, s, kvh, hd)
    kw = dict(causal=causal, window=window, scale=hd ** -0.5, cap=cap, chunk=chunk)
    _close(PL.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw),
           RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_attention_decode_positions():
    """One query at an explicit position against a longer key range (the
    write-then-attend decode call)."""
    q, k, v = _rand(13, 2, 1, 4, 8), _rand(14, 2, 24, 2, 8), _rand(15, 2, 24, 2, 8)
    kw = dict(causal=True, window=None, scale=0.3)
    _close(PL.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        q_positions=torch.tensor([13]),
                        kv_positions=torch.arange(24), **kw),
           RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_positions=jnp.asarray([13]),
                        kv_positions=jnp.arange(24), **kw))


def _smoke_pair():
    ref = ref_smoke(RR.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    port = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    return ref, port


def test_qkv_project_and_mlp():
    ref, port = _smoke_pair()
    d, h, kvh, hd, f = ref.d_model, ref.n_heads, ref.n_kv_heads, ref.head_dim, ref.d_ff
    p = {"attn/wq": 0.1 * _rand(16, d, h, hd), "attn/wk": 0.1 * _rand(17, d, kvh, hd),
         "attn/wv": 0.1 * _rand(18, d, kvh, hd), "attn/q_norm": 0.1 * _rand(19, hd),
         "attn/k_norm": 0.1 * _rand(20, hd), "mlp/w_gate": 0.1 * _rand(21, d, f),
         "mlp/w_up": 0.1 * _rand(22, d, f), "mlp/w_down": 0.1 * _rand(23, f, d)}
    x = _rand(24, 2, 5, d)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.tensor(v) for k, v in p.items()}
    for got, want in zip(PL.qkv_project(port, pt, "attn", torch.tensor(x)),
                         RL.qkv_project(ref, pj, "attn", jnp.asarray(x))):
        _close(got, want)
    _close(PL.mlp_block(port, pt, torch.tensor(x)), RL.mlp_block(ref, pj, jnp.asarray(x)),
           rtol=1e-5, atol=2e-5)
