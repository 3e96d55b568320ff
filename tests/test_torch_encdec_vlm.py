"""The enc-dec and VLM slice against the reference on the same numpy
inputs: whisper-large-v3 (a bidirectional encoder over stub frame
embeddings, decoder cross-attention, sinusoidal positions) and
llava-next-34b (stub image embeddings projected by ``vlm/proj`` and put
before the text), on their smoke configs with the reference's weights
carried across by ``convert.params_from_reference``.

Tolerances, each the reference's own where it has one:
  * ``sinusoidal_at``: the reference's ``test_arch_smoke`` tolerance (0.15)
    and a tight bound besides: two f32 ulps of the largest angle plus one of
    the result.  XLA's ``pow`` and PyTorch's differ by an ulp of the angle
    here and there, and sin / cos pass it on with slope <= 1;
  * the layers (``cross_attn_block``, ``encode_cross_kv``): f32 at 1e-5,
    as tests/test_torch_layers.py holds the other layers;
  * ``encoder_forward`` and ``forward``: f32 logits at 1.6e-5 plus 1e-6 of
    |logit| (the dense archs' bound, tests/test_torch_transformer.py), bf16
    at 5e-2 (the reference's flash-path tolerance); ``loss_fn`` at rel 3e-7
    (f32);
  * prefill then one decode against a full forward: the reference's
    ``test_arch_smoke`` rule (0.15, correlation > 0.99), and against the
    reference's same steps in f32 at the dense bound;
  * gradients of ``loss_fn`` at rtol 1e-4 with atol 1e-6 * max|g| of each
    leaf (the MoE and recurrent archs' rule); one train step: the loss at
    rel 1e-5 and the params at atol 1e-5, as tests/test_torch_train.py
    holds qwen3's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import smoke_config as ref_smoke
from repro.models import cache as rcache
from repro.models import layers as RL
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch
from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)
torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals

ARCHS = ["whisper-large-v3", "llava-next-34b"]
TOL = dict(rtol=5e-2, atol=5e-2)
F32_LOGITS = dict(rtol=1e-6, atol=1.6e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(arch, act="float32"):
    ref_cfg = ref_smoke(RR.get_arch(arch)).with_(activation_dtype=act)
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype=act)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _embeds(cfg, b, seed):
    """The stub frontends' inputs as numpy: 0.01 * N(0, 1), as the
    reference's test_arch_smoke draws them."""
    out = {}
    if cfg.vlm:
        out["img_embeds"] = _rand(seed, b, cfg.vlm.num_image_tokens, cfg.d_model,
                                  scale=0.01)
    if cfg.encdec:
        out["enc_embeds"] = _rand(seed + 1, b, cfg.encdec.enc_seq, cfg.d_model,
                                  scale=0.01)
    return out


def _jnp(d, dt=None):
    return {k: jnp.asarray(v) if dt is None else jnp.asarray(v).astype(dt)
            for k, v in d.items()}


def _torch(d, dt=None):
    return {k: torch.as_tensor(v) if dt is None else torch.as_tensor(v).to(dt)
            for k, v in d.items()}


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("dim,n", [(64, 64), (1280, 1500)], ids=str)
def test_sinusoidal_at_matches_reference(dim, n):
    """Smoke width, and whisper's 1280 over its 1500 encoder frames (its
    448 decoder positions lie inside them)."""
    pos = np.arange(n)
    want = np.asarray(RL.sinusoidal_at(jnp.asarray(pos), dim))
    got = L.sinusoidal_at(torch.as_tensor(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0.15, atol=0.15)
    bound = 2 * 2.0 ** (np.floor(np.log2(max(n - 1, 1))) - 23) + 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
    np.testing.assert_array_equal(L.sinusoidal_positions(n, dim).numpy(), got.numpy())


def test_cross_attention_layers_match_reference():
    """encode_cross_kv over an encoder output and cross_attn_block over its
    K/V (non-causal, chunked queries), f32."""
    cfg = smoke_config(R.get_arch("whisper-large-v3"))
    ref_cfg = ref_smoke(RR.get_arch("whisper-large-v3"))
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"xattn/wq": _rand(1, d, h, hd, scale=0.1), "xattn/wk": _rand(2, d, kv, hd, scale=0.1),
         "xattn/wv": _rand(3, d, kv, hd, scale=0.1), "xattn/wo": _rand(4, h * hd, d, scale=0.1)}
    enc = _rand(5, 2, 24, d)
    x = _rand(6, 2, 40, d)              # 40 queries: chunks of attn_chunk = 32
    want_kv = RL.encode_cross_kv(ref_cfg, _jnp(p), jnp.asarray(enc))
    got_kv = L.encode_cross_kv(cfg, _torch(p), torch.as_tensor(enc))
    np.testing.assert_allclose(got_kv.k.numpy(), np.asarray(want_kv.k), **LAYER_TOL)
    np.testing.assert_allclose(got_kv.v.numpy(), np.asarray(want_kv.v), **LAYER_TOL)
    want = RL.cross_attn_block(ref_cfg, _jnp(p), jnp.asarray(x), want_kv)
    got = L.cross_attn_block(cfg, _torch(p), torch.as_tensor(x), got_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# -- schema and weights ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_schema_and_params_from_reference(arch):
    """The port's schema has the reference's names (``enc/...``,
    ``xattn/...``, ``norm_x``, ``vlm/proj``), shapes and init scales, and
    ``params_from_reference`` carries every leaf across unchanged."""
    ref_cfg, cfg, ref_params, params = _pair(arch)
    ref, port = RT.schema(ref_cfg), T.schema(cfg)
    assert set(ref) == set(port)
    for name, d in port.items():
        assert d.shape == ref[name].shape and d.scale == ref[name].scale, name
    assert any(k.startswith("enc/") for k in port) == (cfg.encdec is not None)
    assert ("vlm/proj" in port) == (cfg.vlm is not None)
    for k, w in params.items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref_params[k]), err_msg=k)
    full_ref, full = RR.get_arch(arch), R.get_arch(arch)
    assert T.param_count(full) == RT.param_count(full_ref)
    with pytest.raises(ValueError, match="missing"):
        params_from_reference({k: np.asarray(v) for k, v in ref_params.items()
                               if not k.startswith(("enc/", "vlm/"))}, cfg)


def test_init_params_in_compute_dtype_draws_the_encoder_by_layer():
    """``init_params(compute_dtype=True)`` draws the stacked encoder leaves
    one layer at a time straight into bf16 (no f32 copy of a stack), and
    ``vlm/proj`` into bf16; norm scales stay f32."""
    for arch in ARCHS:
        cfg = smoke_config(R.get_arch(arch))
        p = launch.init_weights(cfg, seed=0, device="cpu", compute_dtype=True)
        assert set(p) == set(T.schema(cfg))
        if cfg.encdec:
            assert p["enc/layers/p0/attn/wq"].dtype == torch.bfloat16
            assert p["enc/final_norm/scale"].dtype == torch.float32
        if cfg.vlm:
            assert p["vlm/proj"].dtype == torch.bfloat16


# -- the encoder and the full forward ------------------------------------------

def test_encoder_forward_matches_reference():
    ref_cfg, cfg, ref_params, params = _pair("whisper-large-v3")
    enc = _rand(7, 2, cfg.encdec.enc_seq, cfg.d_model, scale=0.01)
    want = RT.encoder_forward(ref_cfg, ref_params, jnp.asarray(enc))
    got = T.encoder_forward(cfg, params, torch.as_tensor(enc))
    assert tuple(got.shape) == (2, cfg.encdec.enc_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_LOGITS)


@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_reference_f32(pair, flash):
    """Forward logits with the stub embeddings (kernel 3's plain version on
    the CPU on the causal decoder layers where ``flash``): llava's logits
    cover the image rows too."""
    ref_cfg, cfg, ref_params, params = pair
    tok = _tokens((2, 12), cfg.vocab, seed=8)
    emb = _embeds(cfg, 2, seed=9)
    want = RT.forward(ref_cfg.with_(use_flash_kernel=flash), ref_params,
                      jnp.asarray(tok), **_jnp(emb)).logits
    got = T.forward(cfg.with_(use_flash_kernel=flash), params,
                    torch.as_tensor(tok).long(), **_torch(emb)).logits
    n_img = cfg.vlm.num_image_tokens if cfg.vlm else 0
    assert tuple(got.shape) == (2, 12 + n_img, cfg.vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch):
    """The archs' own activation dtype (bf16): both packages cast the f32
    masters, the embeddings arrive in bf16."""
    ref_cfg, cfg, ref_params, params = _pair(arch, "bfloat16")
    tok = _tokens((2, 12), cfg.vocab, seed=10)
    emb = _embeds(cfg, 2, seed=11)
    want = RT.forward(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                      jnp.asarray(tok), **_jnp(emb, jnp.bfloat16)).logits
    got = T.forward(cfg, T.cast_params_for_compute(cfg, params),
                    torch.as_tensor(tok).long(), **_torch(emb, torch.bfloat16)).logits
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def test_forward_without_encoder_input_or_cache_raises():
    _, cfg, _, params = _pair("whisper-large-v3")
    with pytest.raises(ValueError, match="enc_out or a cache"):
        T.forward(cfg, params, torch.zeros((1, 4), dtype=torch.long))


def test_loss_fn_masks_image_positions_and_matches_reference(pair):
    """``loss_fn``: llava's image positions carry label -1 (the loss equals
    cross_entropy over the text positions alone); rel 3e-7 in f32."""
    ref_cfg, cfg, ref_params, params = pair
    tok = _tokens((2, 12), cfg.vocab, seed=12)
    labels = _tokens((2, 12), cfg.vocab, seed=13)
    labels[0, :3] = -1
    emb = _embeds(cfg, 2, seed=14)
    batch = {"tokens": tok, "labels": labels, **emb}
    want = float(RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                            _jnp(batch)))
    tb = {k: torch.as_tensor(v).long() if k in ("tokens", "labels")
          else torch.as_tensor(v) for k, v in batch.items()}
    got = T.loss_fn(cfg, T.cast_params_for_compute(cfg, params), tb)
    assert float(got) == pytest.approx(want, rel=3e-7)
    if cfg.vlm:
        n_img = cfg.vlm.num_image_tokens
        logits = T.forward(cfg, params, tb["tokens"], img_embeds=tb["img_embeds"]).logits
        text_only = T.cross_entropy(logits[:, n_img:], tb["labels"])
        assert float(got) == pytest.approx(float(text_only), rel=1e-6)


def test_grads_match_reference_f32(pair):
    """Gradients of ``loss_fn`` through the cast, the encoder, the
    cross-attention and the image projection, every leaf at rtol 1e-4 with
    atol 1e-6 * max|g| of its leaf (the MoE and recurrent archs' rule,
    tests/test_torch_transformer.py)."""
    ref_cfg, cfg, ref_params, params = pair
    batch = {"tokens": _tokens((2, 12), cfg.vocab, seed=20),
             "labels": _tokens((2, 12), cfg.vocab, seed=21), **_embeds(cfg, 2, seed=22)}

    def ref_loss(p):
        return RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, p), _jnp(batch))
    want, want_g = jax.value_and_grad(ref_loss)(ref_params)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    tb = {k: torch.as_tensor(v).long() if k in ("tokens", "labels")
          else torch.as_tensor(v) for k, v in batch.items()}
    loss = T.loss_fn(cfg, T.cast_params_for_compute(cfg, leaves), tb)
    names = sorted(leaves)
    got_g = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names],
                                                allow_unused=True,
                                                materialize_grads=True)))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for k, g in got_g.items():
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=k)
    if cfg.encdec:
        assert np.abs(np.asarray(want_g["enc/layers/p0/attn/wq"])).max() > 0
    if cfg.vlm:
        assert np.abs(np.asarray(want_g["vlm/proj"])).max() > 0


# -- serving steps -------------------------------------------------------------

@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch, act):
    """The twin of the reference's test_arch_smoke.py:66: make_prefill_step
    over S tokens with the stub embeddings, grow_cache by one row, one
    serve step at write_pos S + image rows (the cache's xk/xv carry the
    encoder), against a full forward over S + 1 at 0.15 with correlation >
    0.99; in f32 also against the reference's same three steps at the dense
    bound."""
    ref_cfg, cfg, ref_params, params = _pair(arch, act)
    b, s = 2, 16
    tok = _tokens((b, s + 1), cfg.vocab, seed=15)
    emb = _embeds(cfg, b, seed=16)
    dt = getattr(torch, act)
    temb = _torch(emb, dt)
    n_img = cfg.vlm.num_image_tokens if cfg.vlm else 0
    full = R._final_logits(cfg, T.forward(cfg, T.cast_params_for_compute(cfg, params),
                                          torch.as_tensor(tok).long(),
                                          **temb).logits[:, -1])
    pre, cache = R.make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(tok[:, :s]).long(),
                                                   **temb})
    if cfg.encdec:
        assert tuple(cache["scan"][0]["xk"].shape[1:]) == (
            2, cfg.encdec.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    grown = C.grow_cache(cache, 1, cfg)
    got, _ = R.make_serve_step(cfg)(params, {"tokens": torch.as_tensor(tok[:, s:]).long(),
                                             "cache": grown, "write_pos": s + n_img})
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0.15, atol=0.15)
    assert np.corrcoef(got.numpy().ravel(), full.numpy().ravel())[0, 1] > 0.99
    if act != "float32":
        return
    want_pre, ref_cache = RR.make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(tok[:, :s]), **_jnp(emb)})
    np.testing.assert_allclose(pre.numpy(), _f32(want_pre), **F32_LOGITS)
    want, _ = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok[:, s:]), "cache": rcache.grow_cache(ref_cache, 1),
        "write_pos": jnp.asarray(s + n_img, jnp.int32)})
    np.testing.assert_allclose(got.numpy(), _f32(want), **F32_LOGITS)


def test_run_prefill_takes_the_stub_embeddings():
    """``launch.run_prefill`` forwards ``img_embeds`` / ``enc_embeds`` to the
    prefill step; ``stub_embeds`` draws them seeded, 0.01 * N(0, 1), in the
    activation dtype, and nothing for a text-only model."""
    for arch in ARCHS:
        cfg = smoke_config(R.get_arch(arch))
        params = launch.init_weights(cfg, seed=0, device="cpu")
        emb = launch.stub_embeds(cfg, 2, seed=5, device="cpu")
        again = launch.stub_embeds(cfg, 2, seed=5, device="cpu")
        assert sorted(emb) == (["enc_embeds"] if cfg.encdec else ["img_embeds"])
        for k, v in emb.items():
            assert v.dtype == torch.bfloat16 and torch.equal(v, again[k])
            assert 0.005 < float(v.float().std()) < 0.02
        tok = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1))
        got, _ = launch.run_prefill(cfg, params, tok, **emb)
        want, _ = R.make_prefill_step(cfg)(params, {"tokens": tok, **emb})
        assert torch.equal(got, want)
    assert launch.stub_embeds(smoke_config(R.get_arch("qwen3-0.6b")), 2,
                              device="cpu") == {}


# -- training -------------------------------------------------------------------

def test_train_step_matches_reference(pair):
    """One AdamW step of make_train_step with the stub embeddings in the
    batch (numpy, cast to the activation dtype by the step; microbatches
    of 1 split them with the tokens): the loss at rel 1e-5, every param at
    atol 1e-5 against the reference's jitted step."""
    ref_cfg, cfg, ref_params, params = pair
    tok = _tokens((2, 12), cfg.vocab, seed=17)
    batch = {"tokens": tok, "labels": _tokens((2, 12), cfg.vocab, seed=18),
             **_embeds(cfg, 2, seed=19)}
    ref_step = RR.make_train_step(ref_cfg, micro_batches=2)
    want_p, _, want_m = jax.jit(ref_step)(ref_params, ref_step.init_opt(ref_params),
                                          _jnp(batch))
    step = R.make_train_step(cfg, micro_batches=2)
    p, _, m = step(params, step.init_opt(params), batch)
    assert float(m["loss"]) == pytest.approx(float(want_m["loss"]), rel=1e-5)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    for k, v in p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]), atol=1e-5, err_msg=k)
