"""The port's transformer (schema, forward, caches, serving steps) on smoke
qwen3 against the reference, with the reference's weights carried across by
``convert.params_from_reference``: forward logits at 5e-2 (the reference's
flash-path tolerance, tests/test_flash_attention.py), prefill-then-decode
vs a full forward at 0.15 with correlation > 0.99 (tests/test_arch_smoke.py).
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
    cache = C.grow_cache(cache, 1)
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
                                  "deepseek-v2-lite-16b", "whisper-large-v3"])
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
    grown = C.grow_cache(cache, 3)
    leaf = grown["scan"][0]["k"]
    assert leaf.shape[2] == 11
    assert bool((leaf[:, :, :8] == 1).all()) and bool((leaf[:, :, 8:] == 0).all())


@pytest.mark.parametrize("arch,what", [
    ("deepseek-v2-lite-16b", "MLA"), ("qwen3-moe-30b-a3b", "MoE"),
    ("recurrentgemma-2b", "recurrent"), ("xlstm-350m", "recurrent"),
    ("whisper-large-v3", "enc-dec"), ("llava-next-34b", "VLM")])
def test_unported_paths_raise_naming_their_roadmap_item(arch, what):
    cfg = smoke_config(R.get_arch(arch))
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP Queue 1 item"):
        T.schema(cfg)


def test_training_and_windowed_decode_raise():
    """Training is ported (tests/test_torch_train.py); what it does not
    cover raises: the vocab-parallel loss and the VLM's loss."""
    from repro_torch.launch.mesh import HostMesh
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 16g"):
        T.cross_entropy(torch.zeros((1, 2, 8)), torch.zeros((1, 2), dtype=torch.long),
                        mesh=HostMesh((1, 2)))
    with pytest.raises(NotImplementedError, match="VLM.*ROADMAP Queue 1 item 16f"):
        T.loss_fn(smoke_config(R.get_arch("llava-next-34b")), {},
                  {"tokens": torch.zeros((1, 2), dtype=torch.long)})
    cfg = smoke_config(R.get_arch("gemma2-2b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    cache = C.build_cache(cfg, 1, 8, device="cpu")       # window 16 >= 8: ring
    with pytest.raises(NotImplementedError, match="windowed"):
        R.make_serve_step(cfg)(params, {"tokens": torch.zeros((1, 1), dtype=torch.long),
                                        "cache": cache, "write_pos": 3})
