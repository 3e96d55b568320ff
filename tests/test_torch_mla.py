"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and
the deepseek-v2-lite stack that runs it, against the reference's
(``repro.models.mla``) at smoke size: kv_lora 32, qk_nope 16, rope 8,
v_head 16, four heads, d_model 64, on the same numpy inputs.

Tolerances: in f32 the dense parity bound, rtol 1e-6 / atol 1.6e-5 per
element (``F32_LOGITS`` of tests/test_torch_transformer.py); in bf16 each
element within 2 bf16 ulps of the reference's value; gradients at rtol
1e-4 with atol 1e-6 max|g| of each leaf; prefill then one decode step
against a full forward at the reference's 0.15 with correlation > 0.99
(tests/test_arch_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import smoke_config as ref_smoke
from repro.models import cache as rcache
from repro.models import mla as rmla
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 24
F32_LOGITS = dict(rtol=1e-6, atol=1.6e-5)


def _cfgs(act="float32"):
    return (ref_smoke(RR.get_arch(ARCH)).with_(activation_dtype=act),
            smoke_config(R.get_arch(ARCH)).with_(activation_dtype=act))


def _params(cfg, seed=0):
    """Numpy f32 leaves of one MLA layer, large enough that the attention
    is far from uniform, with a non-zero latent norm scale."""
    rng = np.random.default_rng(seed)
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    shapes = {"mla/wq": (d, h, m.qk_nope_dim + m.qk_rope_dim),
              "mla/w_dkv": (d, m.kv_lora_rank),
              "mla/kv_norm": (m.kv_lora_rank,),
              "mla/w_kr": (d, m.qk_rope_dim),
              "mla/w_uk": (m.kv_lora_rank, h, m.qk_nope_dim),
              "mla/w_uv": (m.kv_lora_rank, h, m.v_head_dim),
              "mla/wo": (h * m.v_head_dim, d)}
    return {k: (0.25 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_block(ref_cfg, params, x, *, positions, cache=None, write_pos=0,
               return_cache=False):
    jdt = jnp.dtype(ref_cfg.activation_dtype)
    return rmla.mla_block(
        ref_cfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jdt), positions=jnp.asarray(positions),
        cache=cache, write_pos=write_pos, return_cache=return_cache)


def _port_block(cfg, params, x, *, positions, cache=None, write_pos=0,
                return_cache=False):
    tdt = getattr(torch, cfg.activation_dtype)
    pos = torch.as_tensor(np.asarray(positions)).long()
    return mla.mla_block(
        cfg, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x).to(tdt), positions=pos,
        rope=L.rope_tables(pos, cfg.mla.qk_rope_dim, cfg.rope_theta),
        cache=cache, write_pos=write_pos, return_cache=return_cache)


def _latent_cache(cfg, rows, seed=2):
    """A bf16 latent cache of ``rows`` random rows per batch row: numpy
    arrays for the reference, tensors for the port (same values)."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    ckv = rng.standard_normal((B, rows, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, rows, m.qk_rope_dim)).astype(np.float32)
    ref = {"ckv": jnp.asarray(ckv).astype(jnp.bfloat16),
           "kr": jnp.asarray(kr).astype(jnp.bfloat16)}
    port = {"ckv": torch.from_numpy(ckv).bfloat16(),
            "kr": torch.from_numpy(kr).bfloat16()}
    return ref, port


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (normal range)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# -- the block ---------------------------------------------------------------

def test_materialized_branch_matches_reference():
    ref_cfg, cfg = _cfgs()
    params, x = _params(cfg), _x(cfg, (B, S))
    want, _ = _ref_block(ref_cfg, params, x, positions=np.arange(S))
    got, cache = _port_block(cfg, params, x, positions=np.arange(S))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_LOGITS)


def test_materialized_branch_returns_the_references_latents():
    ref_cfg, cfg = _cfgs()
    params, x = _params(cfg, seed=3), _x(cfg, (B, S), seed=4)
    _, want = _ref_block(ref_cfg, params, x, positions=np.arange(S),
                         return_cache=True)
    _, got = _port_block(cfg, params, x, positions=np.arange(S),
                         return_cache=True)
    assert sorted(got) == sorted(want) == ["ckv", "kr"]
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_allclose(_f32(got[name]), _f32(want[name]),
                                   **F32_LOGITS)


@pytest.mark.parametrize("write_pos", [0, 7, 23])
def test_absorbed_branch_matches_reference(write_pos):
    """One token written into a 24-row bf16 latent cache at ``write_pos``
    and attended (absorbed form): output and every cache row."""
    ref_cfg, cfg = _cfgs()
    params, x = _params(cfg, seed=5), _x(cfg, (B, 1), seed=6)
    ref_cache, cache = _latent_cache(cfg, S)
    want, want_cache = _ref_block(ref_cfg, params, x, positions=[write_pos],
                                  cache=ref_cache, write_pos=write_pos)
    got, got_cache = _port_block(cfg, params, x, positions=[write_pos],
                                 cache=cache, write_pos=write_pos)
    assert got_cache is cache                      # written in place
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_LOGITS)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_f32(cache[name]), _f32(want_cache[name]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_chunk_through_cached_branch_matches_token_by_token(chunk):
    """16 tokens at positions 4..19 of a 24-row cache whose first 4 rows
    hold a prefix: chunks of ``chunk`` rows through the port's cached branch
    against the reference's single-token steps, each row's output and the
    cache."""
    ref_cfg, cfg = _cfgs()
    params, x = _params(cfg, seed=7), _x(cfg, (B, 16), seed=8)
    ref_cache, cache = _latent_cache(cfg, S, seed=9)
    ref_cache = {k: v.at[:, 4:].set(0) for k, v in ref_cache.items()}
    for v in cache.values():
        v[:, 4:] = 0
    want = []
    for i in range(16):
        out, ref_cache = _ref_block(ref_cfg, params, x[:, i:i + 1],
                                    positions=[4 + i], cache=ref_cache,
                                    write_pos=4 + i)
        want.append(_f32(out))
    got = []
    for start in range(0, 16, chunk):
        end = min(start + chunk, 16)
        out, _ = _port_block(cfg, params, x[:, start:end],
                             positions=np.arange(4 + start, 4 + end),
                             cache=cache, write_pos=4 + start)
        got.append(_f32(out))
    np.testing.assert_allclose(np.concatenate(got, axis=1),
                               np.concatenate(want, axis=1), **F32_LOGITS)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_f32(cache[name]), _f32(ref_cache[name]),
                                   rtol=0, atol=0)


def test_cached_branch_refuses_an_overrun():
    _, cfg = _cfgs()
    _, cache = _latent_cache(cfg, 8)
    with pytest.raises(ValueError, match="overruns the latent cache"):
        _port_block(cfg, _params(cfg), _x(cfg, (B, 3)), positions=[6, 7, 8],
                    cache=cache, write_pos=6)


@pytest.mark.parametrize("branch", ["materialized", "absorbed"])
def test_bf16_within_two_ulps(branch):
    """The block in bf16 activations: every output element within 2 bf16
    ulps of the reference's (the reference rounds every bf16 op, the port
    keeps its dtype at each step)."""
    ref_cfg, cfg = _cfgs("bfloat16")
    params = _params(cfg, seed=10)
    if branch == "materialized":
        x, kw = _x(cfg, (B, S), seed=11), dict(positions=np.arange(S))
        want, _ = _ref_block(ref_cfg, params, x, **kw)
        got, _ = _port_block(cfg, params, x, **kw)
    else:
        x = _x(cfg, (B, 1), seed=11)
        ref_cache, cache = _latent_cache(cfg, S, seed=12)
        want, _ = _ref_block(ref_cfg, params, x, positions=[13],
                             cache=ref_cache, write_pos=13)
        got, _ = _port_block(cfg, params, x, positions=[13], cache=cache,
                             write_pos=13)
    assert got.dtype == torch.bfloat16
    g, w = _f32(got), _f32(want)
    assert (np.abs(g - w) <= 2 * _bf16_ulp(w)).all(), np.abs(g - w).max()


# -- the deepseek-v2-lite stack --------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    ref_cfg, cfg = _cfgs()
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_schema_and_counts_match_reference():
    """Names, shapes and init scales of every leaf, at smoke size and at
    full size, and the parameter and active counts."""
    for ref_cfg, cfg in (_cfgs(), (RR.get_arch(ARCH), R.get_arch(ARCH))):
        want, got = RT.schema(ref_cfg), T.schema(cfg)
        assert sorted(got) == sorted(want)
        for k, d in got.items():
            assert (d.shape, d.scale) == (want[k].shape, want[k].scale), k
        assert T.param_count(cfg) == RT.param_count(ref_cfg)
        assert T.active_param_count(cfg) == RT.active_param_count(ref_cfg)
    assert "pre0/mla/w_uk" in got and "layers/p0/mla/kv_norm" in got


def test_forward_and_loss_match_reference(deepseek, monkeypatch):
    """Forward logits and ``loss_fn`` of the smoke stack (a dense-MLP MLA
    prelude layer, two MLA + MoE layers) in f32, with ``use_flash_kernel``
    set: the MLA layers never reach kernel 3."""
    from repro_torch.kernels import ops as kops

    def no_kernel(*a, **k):
        raise AssertionError("an MLA layer reached the flash-attention kernel")
    monkeypatch.setattr(kops, "flash_attention", no_kernel)
    ref_cfg, cfg, ref_params, params = deepseek
    tok = _tokens((2, 24), cfg.vocab, seed=20)
    want = RT.forward(ref_cfg, ref_params, jnp.asarray(tok)).logits
    got = T.forward(cfg.with_(use_flash_kernel=True),
                    T.cast_params_for_compute(cfg, params),
                    torch.as_tensor(tok).long()).logits
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_LOGITS)
    labels = _tokens((2, 24), cfg.vocab, seed=21)
    labels[0, :3] = -1
    batch = {"tokens": tok, "labels": labels}
    want = float(RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                            {k: jnp.asarray(v) for k, v in batch.items()}))
    got = float(T.loss_fn(cfg, T.cast_params_for_compute(cfg, params),
                          {k: torch.as_tensor(v).long() for k, v in batch.items()}))
    assert got == pytest.approx(want, rel=3e-7)


def test_grads_match_reference(deepseek):
    """Gradients of ``loss_fn`` through the cast, every leaf (the latent
    projections and norm included) at rtol 1e-4 with atol 1e-6 max|g|."""
    ref_cfg, cfg, ref_params, params = deepseek
    batch = {"tokens": _tokens((2, 24), cfg.vocab, seed=22),
             "labels": _tokens((2, 24), cfg.vocab, seed=23)}

    def ref_loss(p):
        return RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, p),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    want, want_g = jax.value_and_grad(ref_loss)(ref_params)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = T.loss_fn(cfg, T.cast_params_for_compute(cfg, leaves),
                     {k: torch.as_tensor(v).long() for k, v in batch.items()})
    names = sorted(leaves)
    got_g = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    assert np.abs(np.asarray(want_g["layers/p0/mla/w_uk"])).max() > 0


def test_prefill_then_decode_matches_full_forward(deepseek):
    """make_prefill_step over S tokens (materialized), grow_cache by a row
    and one absorbed decode step: the reference's 0.15 and correlation >
    0.99 against a full forward over S + 1, and the reference's own three
    steps within the f32 bound; the prefill's latent cache against the
    reference's."""
    ref_cfg, cfg, ref_params, params = deepseek
    b, s = 2, 16
    tok = _tokens((b, s + 1), cfg.vocab, seed=24)
    full = R._final_logits(cfg, T.forward(cfg, params,
                                          torch.as_tensor(tok).long()).logits[:, -1])
    got_pre, cache = R.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(tok[:, :s]).long()})
    want_pre, ref_cache = RR.make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(tok[:, :s])})
    np.testing.assert_allclose(got_pre.numpy(), _f32(want_pre), **F32_LOGITS)
    for group in ("pre", "scan"):
        for layer, ref_layer in zip(cache[group], ref_cache[group]):
            assert sorted(layer) == sorted(ref_layer) == ["ckv", "kr"]
            for name in layer:
                np.testing.assert_allclose(_f32(layer[name]), _f32(ref_layer[name]),
                                           **F32_LOGITS)
    got, _ = R.make_serve_step(cfg)(params, {
        "tokens": torch.as_tensor(tok[:, s:]).long(), "cache": C.grow_cache(cache, 1, cfg),
        "write_pos": s})
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0.15, atol=0.15)
    assert np.corrcoef(got.numpy().ravel(), full.numpy().ravel())[0, 1] > 0.99
    want, _ = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok[:, s:]), "cache": rcache.grow_cache(ref_cache, 1),
        "write_pos": jnp.asarray(s, jnp.int32)})
    np.testing.assert_allclose(got.numpy(), _f32(want), **F32_LOGITS)


def test_grow_cache_pads_latent_rows():
    """grow_cache pads the latents' seq axis (-2), stacked or not."""
    _, cfg = _cfgs()
    cache = C.build_cache(cfg, 2, 8, device="cpu")
    for layer in (cache["pre"][0], cache["scan"][0]):
        for leaf in layer.values():
            leaf.fill_(1)
    grown = C.grow_cache(cache, 3, cfg)
    for layer in (grown["pre"][0], grown["scan"][0]):
        for name, leaf in layer.items():
            assert leaf.shape[-2] == 11, name
            assert bool((leaf[..., :8, :] == 1).all())
            assert bool((leaf[..., 8:, :] == 0).all())
    assert C.build_kv_factors(cfg, 2, 8, 4, device="cpu")["scan"] == ({},)
