"""The port's transformer (schema, forward, caches, serving steps) on smoke
configs against the reference, with the reference's weights carried across
by ``convert.params_from_reference``: forward logits at 5e-2 (the
reference's flash-path tolerance, tests/test_flash_attention.py),
prefill-then-decode vs a full forward at 0.15 with correlation > 0.99
(tests/test_arch_smoke.py).

Across the dense archs the port serves (qwen3, gemma2, codeqwen1.5,
command-r-plus), in f32 activations: forward logits and prefill-then-decode
logits within 1.6e-5 + 1e-6 relative of the reference's, ``loss_fn`` within
3e-7 relative.
gemma2's windowed layers decode over a ring-buffer cache of window rows:
token-by-token decode past the window, chunked prefill across the ring's
end (chunks of 1, 5 and 16 rows against the reference's token-by-token
prefill) and the masked decode at a clock past the window, each within
1e-4 of the reference's logits and one bf16 ulp of its cache rows.
The routed-MoE arch (smoke qwen3-moe, f32): forward and ``loss_fn`` at the
dense bounds, gradients at rtol 1e-4 / atol 1e-6 max|g|, and prefill then
decode against a full forward and against the reference's steps.
The recurrent archs (smoke recurrentgemma-2b and xlstm-350m): the schema,
forward and ``loss_fn`` (f32 at the dense bounds, bf16 at ``TOL`` and the
loss at 1e-2), gradients as for the MoE, prefill then decode against the
reference's steps and a full forward, recurrentgemma's decode on the
cache of a two-window prefill, and chunked serve steps (1, 5, 16 rows)
against the reference's token by token at 1e-4 (k/v within a bf16 ulp),
in f32 with f32 conv leaves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import smoke_config as ref_smoke
from repro.models import cache as rcache
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import cache as C
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(scope="module")
def qwen():
    ref_cfg = ref_smoke(RR.get_arch("qwen3-0.6b"))
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def test_configs_are_the_references():
    from repro.configs.archs import ARCHS as REF_ARCHS
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        assert repr(cfg).replace("repro_torch.", "repro.") == repr(REF_ARCHS[name]), name


def test_schema_matches_reference(qwen):
    ref_cfg, cfg, _, _ = qwen
    ref, port = RT.schema(ref_cfg), T.schema(cfg)
    assert set(ref) == set(port)
    for name, d in port.items():
        assert d.shape == ref[name].shape and d.scale == ref[name].scale, name
    full = R.get_arch("qwen3-0.6b")
    assert T.param_count(full) == RT.param_count(RR.get_arch("qwen3-0.6b"))


def test_init_params_shapes_and_scales():
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    for name, d in T.schema(cfg).items():
        assert tuple(params[name].shape) == d.shape, name
        std = float(params[name].std()) if d.scale else 0.0
        assert std == pytest.approx(d.scale, rel=0.2, abs=1e-7), name


@pytest.mark.parametrize("flash", [False, True])
def test_forward_logits_match_reference(qwen, flash):
    """The port's forward (blockwise attention, or the flash kernel's plain
    version on CPU) vs the reference's blockwise jnp path."""
    ref_cfg, cfg, ref_params, params = qwen
    tok = _tokens((2, 32), cfg.vocab)
    want = RT.forward(ref_cfg, ref_params, jnp.asarray(tok)).logits
    got = T.forward(cfg.with_(use_flash_kernel=flash), params,
                    torch.as_tensor(tok).long()).logits
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def test_prefill_step_matches_reference(qwen):
    ref_cfg, cfg, ref_params, params = qwen
    tok = _tokens((2, 24), cfg.vocab, seed=2)
    want, want_cache = RR.make_prefill_step(ref_cfg)(ref_params,
                                                     {"tokens": jnp.asarray(tok)})
    got, cache = R.make_prefill_step(cfg.with_(use_flash_kernel=True))(
        params, {"tokens": torch.as_tensor(tok).long()})
    assert tuple(got.shape) == (2, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    leaf, ref_leaf = cache["scan"][0]["k"], want_cache["scan"][0]["k"]
    assert tuple(leaf.shape) == ref_leaf.shape
    np.testing.assert_allclose(_f32(leaf), _f32(ref_leaf), **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_then_decode_matches_full_forward(qwen, flash):
    """Prefill S tokens, grow the cache by one row, decode one more: the
    logits match a full forward over S+1 (the twin of the reference's
    test_prefill_then_decode_matches_full_forward)."""
    _, cfg, _, params = qwen
    cfg = cfg.with_(use_flash_kernel=flash)
    b, s = 2, 16
    tok = torch.as_tensor(_tokens((b, s + 1), cfg.vocab, seed=3)).long()
    want = R._final_logits(cfg, T.forward(cfg, params, tok).logits[:, -1])
    _, cache = R.make_prefill_step(cfg)(params, {"tokens": tok[:, :s]})
    cache = C.grow_cache(cache, 1, cfg)
    got, new_cache = R.make_serve_step(cfg)(params, {
        "tokens": tok[:, s:], "cache": cache, "write_pos": s})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.15, atol=0.15)
    assert np.corrcoef(got.numpy().ravel(), want.numpy().ravel())[0, 1] > 0.99
    assert new_cache is cache                      # written in place


def test_serve_step_matches_reference(qwen):
    ref_cfg, cfg, ref_params, params = qwen
    b, s = 2, 16
    rng = np.random.default_rng(4)
    kv = {name: (0.5 * rng.standard_normal((cfg.n_scan_periods, b, s, cfg.n_kv_heads,
                                            cfg.head_dim))).astype(np.float32)
          for name in ("k", "v")}
    ref_cache = {"pre": (), "rem": (), "scan": (
        {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in kv.items()},)}
    cache = {"pre": (), "rem": (), "scan": (
        {n: torch.tensor(a).bfloat16() for n, a in kv.items()},)}
    tok = _tokens((b, 1), cfg.vocab, seed=5)
    want, want_cache = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok), "cache": ref_cache,
        "write_pos": jnp.asarray(9, jnp.int32)})
    got, got_cache = R.make_serve_step(cfg)(params, {
        "tokens": torch.as_tensor(tok).long(), "cache": cache, "write_pos": 9})
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL)
    np.testing.assert_allclose(_f32(got_cache["scan"][0]["k"]),
                               _f32(want_cache["scan"][0]["k"]), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b", "recurrentgemma-2b",
                                  "xlstm-350m", "deepseek-v2-lite-16b",
                                  "whisper-large-v3"])
def test_cache_trees_and_bytes_match_reference(arch):
    ref_cfg, cfg = ref_smoke(RR.get_arch(arch)), smoke_config(R.get_arch(arch))
    ref = rcache.build_cache(ref_cfg, 2, 24)
    port = C.build_cache(cfg, 2, 24, device="cpu")
    for group in ("pre", "scan", "rem"):
        ref_g, port_g = ref[group] or (), port[group] or ()
        assert len(ref_g) == len(port_g)
        for rl, pl in zip(ref_g, port_g):
            assert {k: v.shape for k, v in rl.items()} == \
                   {k: tuple(v.shape) for k, v in pl.items()}
    full_ref, full = RR.get_arch(arch), R.get_arch(arch)
    assert C.cache_bytes(full, 4, 4096) == rcache.cache_bytes(full_ref, 4, 4096)
    assert C.kv_stream_bytes(full, 4096) == rcache.kv_stream_bytes(full_ref, 4096)
    assert C.kv_stream_bytes(full, 4096, rank=32, tail_rows=80) == \
        rcache.kv_stream_bytes(full_ref, 4096, rank=32, tail_rows=80)
    rf = rcache.build_kv_factors(ref_cfg, 2, 24, 4)
    pf = C.build_kv_factors(cfg, 2, 24, 4, device="cpu")
    for rl, pl in zip(rf["scan"] or (), pf["scan"] or ()):
        assert {k: v.shape for k, v in rl.items()} == \
               {k: tuple(v.shape) for k, v in pl.items()}


def test_grow_cache_pads_kv_rows_only():
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    cache = C.build_cache(cfg, 2, 8, device="cpu")
    cache["scan"][0]["k"].fill_(1)
    grown = C.grow_cache(cache, 3, cfg)
    leaf = grown["scan"][0]["k"]
    assert leaf.shape[2] == 11
    assert bool((leaf[:, :, :8] == 1).all()) and bool((leaf[:, :, 8:] == 0).all())


def test_training_and_windowed_decode_raise(gemma2):
    """Windowed (ring) decode is ported: on a cache of fewer rows than the
    window (a ring that never wraps) it runs and matches the reference.
    (Training, the vocab-parallel loss included, is tested in
    tests/test_torch_train.py and tests/test_torch_sharding.py.)"""
    ref_cfg, cfg, ref_params, params = gemma2
    ref_cache = rcache.build_cache(ref_cfg, 1, 8)
    cache = C.build_cache(cfg, 1, 8, device="cpu")       # window 16 >= 8: ring
    assert cache["scan"][0]["k"].shape[2] == 8
    tok = _tokens((1, 4), cfg.vocab, seed=6)
    ref_step = jax.jit(RR.make_serve_step(ref_cfg))
    for i in range(4):
        want, ref_cache = ref_step(ref_params, {
            "tokens": jnp.asarray(tok[:, i:i + 1]), "cache": ref_cache,
            "write_pos": jnp.asarray(i, jnp.int32)})
        got, _ = R.make_serve_step(cfg)(params, {
            "tokens": torch.as_tensor(tok[:, i:i + 1]).long(), "cache": cache,
            "write_pos": i})
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4, atol=1e-4)


# -- gemma2's windowed layers over a ring-buffer cache ------------------------

RING_SEQ, RING_TOKENS = 48, 40          # smoke window 16: the ring wraps twice


@pytest.fixture(scope="module")
def gemma2():
    ref_cfg = ref_smoke(RR.get_arch("gemma2-2b")).with_(activation_dtype="float32")
    cfg = smoke_config(R.get_arch("gemma2-2b")).with_(activation_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module")
def gemma2_ref_decode(gemma2):
    """The reference's serve step token by token over RING_TOKENS positions
    of a (2, RING_SEQ) cache: the logits after each token and the cache."""
    ref_cfg, cfg, ref_params, _ = gemma2
    tok = _tokens((2, RING_TOKENS), cfg.vocab, seed=7)
    step = jax.jit(RR.make_serve_step(ref_cfg))
    cache, logits = rcache.build_cache(ref_cfg, 2, RING_SEQ), []
    for i in range(RING_TOKENS):
        out, cache = step(ref_params, {"tokens": jnp.asarray(tok[:, i:i + 1]),
                                       "cache": cache,
                                       "write_pos": jnp.asarray(i, jnp.int32)})
        logits.append(np.asarray(out))
    return tok, logits, cache


def _assert_caches_close(cache, ref_cache):
    """Every k/v leaf within one bf16 ulp (the same f32 value rounded on
    either side of a bf16 boundary)."""
    for group in ("pre", "scan", "rem"):
        for layer, ref_layer in zip(cache[group] or (), ref_cache[group] or ()):
            for name in layer:
                np.testing.assert_allclose(_f32(layer[name]), _f32(ref_layer[name]),
                                           rtol=1e-2, atol=1e-2)


def test_ring_decode_past_window_matches_reference(gemma2, gemma2_ref_decode):
    _, cfg, _, params = gemma2
    tok, want, ref_cache = gemma2_ref_decode
    cache = C.build_cache(cfg, 2, RING_SEQ, device="cpu")
    assert cache["scan"][0]["k"].shape[2] == 16 and cache["scan"][1]["k"].shape[2] == 48
    step = R.make_serve_step(cfg)
    for i in range(RING_TOKENS):
        got, _ = step(params, {"tokens": torch.as_tensor(tok[:, i:i + 1]).long(),
                               "cache": cache, "write_pos": i})
        np.testing.assert_allclose(got.numpy(), want[i], rtol=1e-4, atol=1e-4)
    _assert_caches_close(cache, ref_cache)


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_chunked_ring_prefill_matches_token_by_token(gemma2, gemma2_ref_decode, chunk):
    """Chunks written in one serve step each, across the ring's end: the
    last token's logits of every chunk and the final caches match the
    reference's token-by-token steps."""
    _, cfg, _, params = gemma2
    tok, want, ref_cache = gemma2_ref_decode
    cache = C.build_cache(cfg, 2, RING_SEQ, device="cpu")
    step = R.make_serve_step(cfg)
    for start in range(0, RING_TOKENS, chunk):
        end = min(start + chunk, RING_TOKENS)
        got, _ = step(params, {"tokens": torch.as_tensor(tok[:, start:end]).long(),
                               "cache": cache, "write_pos": start})
        np.testing.assert_allclose(got.numpy(), want[end - 1], rtol=1e-4, atol=1e-4)
    _assert_caches_close(cache, ref_cache)


def test_masked_decode_past_window_matches_reference(gemma2):
    """ModelStep.decode_logits with a slot mask at a clock past the window:
    the clock's ring slot of the masked-out slot holds one of its live rows,
    which must be restored (the reference's masked cache merge)."""
    from repro.serve.model_step import ModelStep as RefModelStep
    from repro_torch.serve.model_step import ModelStep
    ref_cfg, cfg, ref_params, params = gemma2
    ref = RefModelStep(ref_cfg, ref_params, slots=2, max_seq=RING_SEQ)
    port = ModelStep(cfg, params, slots=2, max_seq=RING_SEQ, device="cpu")
    tok = _tokens((RING_TOKENS,), cfg.vocab, seed=8).tolist()
    for e in (ref, port):
        e.prefill_rows(0, tok[:12], 0)
        e.prefill_rows(0, tok[12:20], 12)
        e.prefill_rows(1, tok[24:30], 0)
    clock = 20                                    # ring slot 20 % 16 = 4
    ring = port.cache["scan"][0]["k"]
    before = ring[:, 1, clock % 16].clone()
    assert before.any()                           # slot 1's live row of pos 4
    tokens, mask = np.array([[tok[30]], [tok[31]]], np.int32), np.array([True, False])
    want = np.asarray(ref.decode_logits(tokens, clock, slot_mask=mask))
    got = port.decode_logits(tokens, clock, slot_mask=mask).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(ring[:, 1, clock % 16], before)
    _assert_caches_close(port.cache, ref.cache)


@pytest.mark.parametrize("s", [40, 48])
def test_windowed_prefill_cache_carries_decode_past_window(gemma2, s):
    """A prefill past the window leaves each local layer's last 16 rows in
    ring order (slot p % 16 holds position p); ``grow_cache(cache, 1, cfg)``
    pads the global layers and leaves the rings as they are, so one decode
    at write_pos S takes the ring branch.  Its logits match the port's own
    full forward over S + 1 at the reference's 0.15 with correlation >
    0.99 (the reference's own decode there is wrong: it clamps its write).
    The rings equal the reference's position-order rows once rotated back,
    within a bf16 ulp."""
    ref_cfg, cfg, ref_params, params = gemma2
    tok = _tokens((2, s + 1), cfg.vocab, seed=17)
    full = R._final_logits(cfg, T.forward(cfg, params,
                                          torch.as_tensor(tok).long()).logits[:, -1])
    _, cache = R.make_prefill_step(cfg)(params,
                                        {"tokens": torch.as_tensor(tok[:, :s]).long()})
    _, ref_cache = RR.make_prefill_step(ref_cfg)(ref_params,
                                                 {"tokens": jnp.asarray(tok[:, :s])})
    for name in ("k", "v"):
        ring = cache["scan"][0][name]
        assert ring.shape[2] == 16
        np.testing.assert_allclose(_f32(torch.roll(ring, -(s % 16), 2)),
                                   _f32(ref_cache["scan"][0][name]), rtol=1e-2, atol=1e-2)
    grown = C.grow_cache(cache, 1, cfg)
    assert grown["scan"][0]["k"].shape[2] == 16 and grown["scan"][1]["k"].shape[2] == s + 1
    assert torch.equal(grown["scan"][0]["k"], cache["scan"][0]["k"])
    got, _ = R.make_serve_step(cfg)(params, {"tokens": torch.as_tensor(tok[:, s:]).long(),
                                             "cache": grown, "write_pos": s})
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0.15, atol=0.15)
    assert np.corrcoef(got.numpy().ravel(), full.numpy().ravel())[0, 1] > 0.99


def test_grow_cache_pads_full_context_and_latent_leaves():
    """grow_cache pads what it padded before the ring repair: every
    full-context k/v leaf (qwen3, gemma2's global layers), a windowed leaf
    shorter than its window (a ring that has not wrapped: gemma2's local
    layers at 8 rows) and the MLA latents, stacked or not; old rows kept,
    new rows zero."""
    for arch, leaves in (("qwen3-0.6b", ("k", "v")), ("gemma2-2b", ("k", "v")),
                         ("deepseek-v2-lite-16b", ("ckv", "kr"))):
        cfg = smoke_config(R.get_arch(arch))
        cache = C.build_cache(cfg, 2, 8, device="cpu")
        for group in ("pre", "scan"):
            for layer in cache[group] or ():
                for name in leaves:
                    layer[name].fill_(1)
        grown = C.grow_cache(cache, 3, cfg)
        n = 0
        for group in ("pre", "scan"):
            for layer in grown[group] or ():
                for name in leaves:
                    leaf = layer[name]
                    axis = leaf.ndim - (3 if name in ("k", "v") else 2)
                    assert leaf.shape[axis] == 11, (arch, group, name)
                    assert bool((leaf.narrow(axis, 0, 8) == 1).all())
                    assert bool((leaf.narrow(axis, 8, 3) == 0).all())
                    n += 1
        assert n >= 2, arch


# -- the dense archs the port serves, in f32 activations ---------------------

DENSE_ARCHS = ["qwen3-0.6b", "gemma2-2b", "codeqwen1.5-7b", "command-r-plus-104b"]
# f32 logits: 1.6e-5, plus 1e-6 of |logit| (16 f32 ulps):
# command-r's logits reach ~66, where a 2.3e-5 difference is 3.5e-7 relative
F32_LOGITS = dict(rtol=1e-6, atol=1.6e-5)


def _f32_pair(arch):
    ref_cfg = ref_smoke(RR.get_arch(arch)).with_(activation_dtype="float32")
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_archs_match_reference_f32(arch):
    """Forward logits (the flash configuration: kernel 3's plain version on
    the CPU where the layer qualifies) and ``loss_fn``."""
    ref_cfg, cfg, ref_params, params = _f32_pair(arch)
    tok = _tokens((2, 24), cfg.vocab, seed=9)
    want = RT.forward(ref_cfg.with_(use_flash_kernel=True), ref_params,
                      jnp.asarray(tok)).logits
    got = T.forward(cfg.with_(use_flash_kernel=True),
                    T.cast_params_for_compute(cfg, params),
                    torch.as_tensor(tok).long()).logits
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_LOGITS)
    labels = _tokens((2, 24), cfg.vocab, seed=10)
    labels[0, :5] = -1
    want = float(RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                            {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}))
    got = float(T.loss_fn(cfg, T.cast_params_for_compute(cfg, params),
                          {"tokens": torch.as_tensor(tok).long(),
                           "labels": torch.as_tensor(labels).long()}))
    assert got == pytest.approx(want, rel=3e-7)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_then_decode_matches_reference_f32(arch):
    """make_prefill_step, grow_cache by one row and one serve step, against
    the reference's same three steps (gemma2's local layers decode over a
    12 + 1 row ring, fewer rows than the window)."""
    ref_cfg, cfg, ref_params, params = _f32_pair(arch)
    b, s = 2, 12
    tok = _tokens((b, s + 1), cfg.vocab, seed=11)
    want, ref_cache = RR.make_prefill_step(ref_cfg)(ref_params,
                                                    {"tokens": jnp.asarray(tok[:, :s])})
    got, cache = R.make_prefill_step(cfg)(params,
                                          {"tokens": torch.as_tensor(tok[:, :s]).long()})
    np.testing.assert_allclose(got.numpy(), _f32(want), **F32_LOGITS)
    want, _ = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok[:, s:]), "cache": rcache.grow_cache(ref_cache, 1),
        "write_pos": jnp.asarray(s, jnp.int32)})
    got, _ = R.make_serve_step(cfg)(params, {
        "tokens": torch.as_tensor(tok[:, s:]).long(), "cache": C.grow_cache(cache, 1, cfg),
        "write_pos": s})
    np.testing.assert_allclose(got.numpy(), _f32(want), **F32_LOGITS)


# -- the routed-MoE arch, in f32 activations ---------------------------------

@pytest.fixture(scope="module")
def moe_f32():
    return _f32_pair("qwen3-moe-30b-a3b")


def test_moe_forward_and_loss_match_reference_f32(moe_f32):
    """Forward logits (kernel 3's plain version on the CPU) and ``loss_fn``
    of the two-layer smoke qwen3-moe: 48 tokens, capacity 15, pairs drop."""
    ref_cfg, cfg, ref_params, params = moe_f32
    tok = _tokens((2, 24), cfg.vocab, seed=12)
    want = RT.forward(ref_cfg.with_(use_flash_kernel=True), ref_params,
                      jnp.asarray(tok)).logits
    got = T.forward(cfg.with_(use_flash_kernel=True),
                    T.cast_params_for_compute(cfg, params),
                    torch.as_tensor(tok).long()).logits
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_LOGITS)
    labels = _tokens((2, 24), cfg.vocab, seed=13)
    labels[1, :4] = -1
    batch = {"tokens": tok, "labels": labels}
    want = float(RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                            {k: jnp.asarray(v) for k, v in batch.items()}))
    got = float(T.loss_fn(cfg, T.cast_params_for_compute(cfg, params),
                          {k: torch.as_tensor(v).long() for k, v in batch.items()}))
    assert got == pytest.approx(want, rel=3e-7)


def test_moe_grads_match_reference_f32(moe_f32):
    """Gradients of ``loss_fn`` through the cast, every leaf (router and
    experts included) at rtol 1e-4 with atol 1e-6 * max|g| of its leaf."""
    ref_cfg, cfg, ref_params, params = moe_f32
    batch = {"tokens": _tokens((2, 24), cfg.vocab, seed=14),
             "labels": _tokens((2, 24), cfg.vocab, seed=15)}

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
    assert np.abs(np.asarray(want_g["layers/p0/moe/router"])).max() > 0


def test_moe_prefill_then_decode_matches_full_forward(moe_f32):
    """Prefill S tokens (capacity over B*S), grow the cache by a row and
    decode one more (B tokens, dropless): the reference's 0.15 and
    correlation > 0.99 against a full forward over S + 1, and the
    reference's own three steps within the f32 bound."""
    ref_cfg, cfg, ref_params, params = moe_f32
    cfg = cfg.with_(use_flash_kernel=True)
    b, s = 2, 16
    tok = _tokens((b, s + 1), cfg.vocab, seed=16)
    full = R._final_logits(cfg, T.forward(cfg, params,
                                          torch.as_tensor(tok).long()).logits[:, -1])
    _, cache = R.make_prefill_step(cfg)(params,
                                        {"tokens": torch.as_tensor(tok[:, :s]).long()})
    got, _ = R.make_serve_step(cfg)(params, {
        "tokens": torch.as_tensor(tok[:, s:]).long(), "cache": C.grow_cache(cache, 1, cfg),
        "write_pos": s})
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0.15, atol=0.15)
    assert np.corrcoef(got.numpy().ravel(), full.numpy().ravel())[0, 1] > 0.99
    _, ref_cache = RR.make_prefill_step(ref_cfg)(ref_params,
                                                 {"tokens": jnp.asarray(tok[:, :s])})
    want, _ = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok[:, s:]), "cache": rcache.grow_cache(ref_cache, 1),
        "write_pos": jnp.asarray(s, jnp.int32)})
    np.testing.assert_allclose(got.numpy(), _f32(want), **F32_LOGITS)


# -- the recurrent archs (recurrentgemma-2b: RG-LRU, RG-LRU, local attention;
# xlstm-350m: 7 mLSTM + 1 sLSTM) --------------------------------------------

RECURRENT_ARCHS = ["recurrentgemma-2b", "xlstm-350m"]


def _pair(arch, act):
    ref_cfg = ref_smoke(RR.get_arch(arch)).with_(activation_dtype=act)
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype=act)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


def _f32_conv(cache):
    """The cache with f32 ``conv`` leaves: in f32 activations the
    reference's conv leaf turns f32 at its first step, so the port's f32
    parity tests give theirs f32 too (a bf16 leaf would round the state)."""
    for group in ("pre", "scan", "rem"):
        for layer in cache[group] or ():
            if "conv" in layer:
                layer["conv"] = layer["conv"].float()
    return cache


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_schema_matches_reference(arch):
    ref_cfg, cfg = ref_smoke(RR.get_arch(arch)), smoke_config(R.get_arch(arch))
    ref, port = RT.schema(ref_cfg), T.schema(cfg)
    assert set(ref) == set(port)
    for name, d in port.items():
        assert d.shape == ref[name].shape and d.scale == ref[name].scale, name
    assert T.param_count(R.get_arch(arch)) == RT.param_count(RR.get_arch(arch))


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_forward_and_loss_match_reference(arch, act):
    """Forward logits and ``loss_fn``: f32 at the dense bounds (logits
    1.6e-5 + 1e-6 relative, the loss 3e-7 relative), bf16 at ``TOL``."""
    ref_cfg, cfg, ref_params, params = _pair(arch, act)
    tok = _tokens((2, 24), cfg.vocab, seed=21)
    want = RT.forward(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                      jnp.asarray(tok)).logits
    got = T.forward(cfg, T.cast_params_for_compute(cfg, params),
                    torch.as_tensor(tok).long()).logits
    assert got.dtype == getattr(torch, act)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32_LOGITS if act == "float32" else TOL))
    labels = _tokens((2, 24), cfg.vocab, seed=22)
    labels[0, :3] = -1
    want = float(RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, ref_params),
                            {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}))
    got = float(T.loss_fn(cfg, T.cast_params_for_compute(cfg, params),
                          {"tokens": torch.as_tensor(tok).long(),
                           "labels": torch.as_tensor(labels).long()}))
    assert got == pytest.approx(want, rel=3e-7 if act == "float32" else 1e-2)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_grads_match_reference_f32(arch):
    """Gradients of ``loss_fn`` through the cast and every mixer (the
    RG-LRU scan, mLSTM's chunks, sLSTM's time loop) at rtol 1e-4 with atol
    1e-6 * max|g| of each leaf."""
    ref_cfg, cfg, ref_params, params = _f32_pair(arch)
    batch = {"tokens": _tokens((2, 20), cfg.vocab, seed=23),
             "labels": _tokens((2, 20), cfg.vocab, seed=24)}

    def ref_loss(p):
        return RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, p),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    want, want_g = jax.value_and_grad(ref_loss)(ref_params)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = T.loss_fn(cfg, T.cast_params_for_compute(cfg, leaves),
                     {k: torch.as_tensor(v).long() for k, v in batch.items()})
    names = sorted(leaves)
    got_g = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names],
                                                allow_unused=True,
                                                materialize_grads=True)))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for k, g in got_g.items():
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_prefill_then_decode_matches_reference(arch, act):
    """make_prefill_step over 16 tokens (smoke recurrentgemma's window),
    grow_cache by one row and one serve step, against the reference's same
    three steps (f32: the dense bounds; bf16: ``TOL``) and against a full
    forward over 17 (0.15, correlation > 0.99)."""
    ref_cfg, cfg, ref_params, params = _pair(arch, act)
    b, s = 2, 16
    tol = F32_LOGITS if act == "float32" else TOL
    tok = _tokens((b, s + 1), cfg.vocab, seed=25)
    want, ref_cache = RR.make_prefill_step(ref_cfg)(ref_params,
                                                    {"tokens": jnp.asarray(tok[:, :s])})
    got, cache = R.make_prefill_step(cfg)(params,
                                          {"tokens": torch.as_tensor(tok[:, :s]).long()})
    np.testing.assert_allclose(got.numpy(), _f32(want), **tol)
    for layer, ref_layer in zip(cache["scan"], ref_cache["scan"]):
        assert sorted(layer) == sorted(ref_layer)
        for name in layer:
            assert layer[name].dtype == getattr(torch, str(ref_layer[name].dtype))
            np.testing.assert_allclose(_f32(layer[name]), _f32(ref_layer[name]),
                                       **(tol if name not in ("k", "v") else TOL))
    grown = C.grow_cache(cache, 1, cfg)
    want, _ = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok[:, s:]), "cache": rcache.grow_cache(ref_cache, 1),
        "write_pos": jnp.asarray(s, jnp.int32)})
    got, _ = R.make_serve_step(cfg)(params, {
        "tokens": torch.as_tensor(tok[:, s:]).long(), "cache": grown, "write_pos": s})
    np.testing.assert_allclose(got.numpy(), _f32(want), **tol)
    full = R._final_logits(cfg, T.forward(cfg, T.cast_params_for_compute(cfg, params),
                                          torch.as_tensor(tok).long()).logits[:, -1])
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0.15, atol=0.15)
    assert np.corrcoef(got.numpy().ravel(), full.numpy().ravel())[0, 1] > 0.99


def test_recurrentgemma_decode_after_two_windows_matches_reference():
    """A 32-token prefill (two smoke windows of 16): the local layers'
    caches hold the last window, which is the ring of write_pos 32 (32 %
    16 == 0), so the decode runs on the prefill's cache as it is, without
    grow_cache; f32, the reference's same two steps at the dense bounds."""
    ref_cfg, cfg, ref_params, params = _f32_pair("recurrentgemma-2b")
    b, s = 2, 32
    tok = _tokens((b, s + 1), cfg.vocab, seed=26)
    _, ref_cache = RR.make_prefill_step(ref_cfg)(ref_params,
                                                 {"tokens": jnp.asarray(tok[:, :s])})
    _, cache = R.make_prefill_step(cfg)(params,
                                        {"tokens": torch.as_tensor(tok[:, :s]).long()})
    assert cache["scan"][2]["k"].shape[2] == 16
    want, _ = RR.make_serve_step(ref_cfg)(ref_params, {
        "tokens": jnp.asarray(tok[:, s:]), "cache": ref_cache,
        "write_pos": jnp.asarray(s, jnp.int32)})
    got, _ = R.make_serve_step(cfg)(params, {
        "tokens": torch.as_tensor(tok[:, s:]).long(), "cache": cache, "write_pos": s})
    np.testing.assert_allclose(got.numpy(), _f32(want), **F32_LOGITS)
    full = R._final_logits(cfg, T.forward(cfg, params,
                                          torch.as_tensor(tok).long()).logits[:, -1])
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_LOGITS)


@pytest.mark.parametrize("chunk", [1, 5, 16])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_chunked_serve_matches_reference_token_by_token(arch, chunk):
    """Chunks through one serve step each on a built cache (recurrentgemma:
    across its 16-row ring's end) against the reference's serve step token
    by token over 40 tokens, in f32 with f32 conv leaves: the last logits
    of every chunk within 1e-4 and the final state leaves at 1e-4 (k/v
    within a bf16 ulp)."""
    ref_cfg, cfg, ref_params, params = _f32_pair(arch)
    n, seq = 40, 48
    tok = _tokens((2, n), cfg.vocab, seed=27)
    step = jax.jit(RR.make_serve_step(ref_cfg))
    ref_cache, want = rcache.build_cache(ref_cfg, 2, seq), []
    for i in range(n):
        out, ref_cache = step(ref_params, {"tokens": jnp.asarray(tok[:, i:i + 1]),
                                           "cache": ref_cache,
                                           "write_pos": jnp.asarray(i, jnp.int32)})
        want.append(np.asarray(out))
    cache = _f32_conv(C.build_cache(cfg, 2, seq, device="cpu"))
    serve = R.make_serve_step(cfg)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        got, _ = serve(params, {"tokens": torch.as_tensor(tok[:, start:end]).long(),
                                "cache": cache, "write_pos": start})
        np.testing.assert_allclose(got.numpy(), want[end - 1], rtol=1e-4, atol=1e-4)
    for layer, ref_layer in zip(cache["scan"], ref_cache["scan"]):
        for name in layer:
            np.testing.assert_allclose(
                _f32(layer[name]), _f32(ref_layer[name]),
                **(dict(rtol=1e-2, atol=1e-2) if name in ("k", "v")
                   else dict(rtol=1e-4, atol=1e-4)))


def test_grow_cache_copies_recurrent_state():
    """grow_cache pads the local layers' k/v and leaves each state leaf's
    values as they were, in a tensor of its own."""
    cfg = smoke_config(R.get_arch("recurrentgemma-2b"))
    cache = C.build_cache(cfg, 2, 8, device="cpu")
    cache["scan"][0]["h"].fill_(3)
    grown = C.grow_cache(cache, 2, cfg)
    assert grown["scan"][2]["k"].shape[2] == 10
    assert torch.equal(grown["scan"][0]["h"], cache["scan"][0]["h"])
    assert grown["rem"][0]["conv"].shape == cache["rem"][0]["conv"].shape
    grown["scan"][0]["h"].zero_()
    assert bool((cache["scan"][0]["h"] == 3).all())
