"""The port's routed Mixture-of-Experts (``repro_torch.models.moe``) against
the reference's (``repro.models.moe``) at smoke size: 8 experts, top-2,
expert width 32, and two shared experts of width 64 where a case has them.

Tolerances: f32 outputs within 1.6e-5 + 1e-6 |ref| per element (the dense
parity bound), bf16 outputs within 2 bf16 ulps of the reference's value per
element, routed expert sets and capacities equal.  B 2 x S 32 gives 64
tokens and 128 picks over 8 experts against a capacity of 20, so pairs
drop; the skewed-router case drops most of them, in the reference's order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke
from repro.models import moe as rmoe
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs.base import smoke_config
from repro_torch.launch import serve as launch
from repro_torch.models import moe
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
B, S = 2, 32
F32_BOUND = dict(rtol=1e-6, atol=1.6e-5)
SHARED = dict(num_shared=2, d_shared=64)


def _cfgs(act="float32", **moe_kw):
    ref_cfg = ref_smoke(RR.get_arch(ARCH)).with_(activation_dtype=act)
    cfg = smoke_config(R.get_arch(ARCH)).with_(activation_dtype=act)
    return (ref_cfg.with_(moe=dataclasses.replace(ref_cfg.moe, **moe_kw)),
            cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw)))


def _params(cfg, seed=0, router_scale=0.3):
    """Numpy f32 leaves of one MoE layer (a router scale that makes the
    routing decisive: no near ties between the top-k and the rest)."""
    rng = np.random.default_rng(seed)
    d, m = cfg.d_model, cfg.moe
    shapes = {"moe/router": (d, m.num_experts),
              "moe/w_gate": (m.num_experts, d, m.d_expert),
              "moe/w_up": (m.num_experts, d, m.d_expert),
              "moe/w_down": (m.num_experts, m.d_expert, d)}
    if m.num_shared:
        shapes.update({"moe/shared/w_gate": (d, m.d_shared),
                       "moe/shared/w_up": (d, m.d_shared),
                       "moe/shared/w_down": (m.d_shared, d)})
    return {k: ((router_scale if k == "moe/router" else 0.1)
                * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _x(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _run_both(ref_cfg, cfg, params, x):
    """(port, reference) outputs as f32 numpy, in the configs' dtype."""
    jdt = jnp.dtype(ref_cfg.activation_dtype)
    tdt = getattr(torch, cfg.activation_dtype)
    want = rmoe.moe_block(ref_cfg, {k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x).astype(jdt))
    got = moe.moe_block(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _port_routes(cfg, params, x):
    tokens = torch.from_numpy(x).reshape(-1, cfg.d_model).to(
        getattr(torch, cfg.activation_dtype))
    logits = tokens.float() @ torch.from_numpy(params["moe/router"])
    return moe.route(cfg, logits)


def _drops(cfg, experts) -> int:
    """Pairs past the capacity of the (N, k) expert ids."""
    n = experts.shape[0]
    cap = moe.capacity(n, cfg.moe.num_experts, cfg.moe.top_k,
                       cfg.moe.capacity_factor)
    counts = torch.bincount(experts.reshape(-1), minlength=cfg.moe.num_experts)
    return int(torch.clamp(counts - cap, min=0).sum())


@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 8.0])
def test_capacity_matches_reference(factor):
    for n in (1, 7, 8, 9, 16, 64, 100, 512, 4096, 4097):
        for e, k in ((8, 2), (64, 6), (128, 8)):
            assert moe.capacity(n, e, k, factor) == rmoe.capacity(n, e, k, factor)


@pytest.mark.parametrize("norm_topk", [True, False], ids=["norm_topk", "raw_gates"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_moe_block_matches_reference_f32(norm_topk, shared):
    ref_cfg, cfg = _cfgs(norm_topk=norm_topk, **(SHARED if shared else {}))
    params, x = _params(cfg), _x(cfg)
    assert _drops(cfg, _port_routes(cfg, params, x)[1]) > 0
    got, want = _run_both(ref_cfg, cfg, params, x)
    np.testing.assert_allclose(got, want, **F32_BOUND)


def test_skewed_router_drops_in_the_references_order():
    """Every token routes to expert 3 (the tokens share an offset the
    router's column 3 reads): 44 of its 64 pairs drop past the capacity of
    20, the last tokens in token order, as the reference's stable sort
    orders them."""
    ref_cfg, cfg = _cfgs()
    params, x = _params(cfg), _x(cfg) + 1.0
    params["moe/router"][:, 3] += 0.5
    _, experts = _port_routes(cfg, params, x)
    assert bool((experts == 3).any(-1).all())
    assert _drops(cfg, experts) >= B * S - 20
    got, want = _run_both(ref_cfg, cfg, params, x)
    np.testing.assert_allclose(got, want, **F32_BOUND)


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_moe_block_bf16_within_two_ulps(shared):
    ref_cfg, cfg = _cfgs("bfloat16", **(SHARED if shared else {}))
    params, x = _params(cfg), _x(cfg)
    got, want = _run_both(ref_cfg, cfg, params, x)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_routed_expert_sets_match_reference(act):
    """The top-k sets over the f32 softmax of the f32 router logits, token by
    token, and their gates."""
    ref_cfg, cfg = _cfgs(act)
    params, x = _params(cfg), _x(cfg)
    gates, experts = _port_routes(cfg, params, x)
    tokens = jnp.asarray(x).reshape(-1, cfg.d_model).astype(
        jnp.dtype(act)).astype(jnp.float32)
    ref_gates, ref_experts = jax.lax.top_k(
        jax.nn.softmax(tokens @ jnp.asarray(params["moe/router"]), axis=-1),
        cfg.moe.top_k)
    assert np.array_equal(np.sort(experts.numpy(), -1),
                          np.sort(np.asarray(ref_experts), -1))
    ref_gates = np.asarray(ref_gates)
    ref_gates = ref_gates / ref_gates.sum(-1, keepdims=True)
    np.testing.assert_allclose(gates.numpy(), ref_gates, rtol=1e-6, atol=1e-7)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    experts = np.argsort(-logits, -1)[:, :2].astype(np.int32)
    want = float(rmoe.aux_load_balance_loss(jnp.asarray(logits),
                                            jnp.asarray(experts), 8))
    got = float(moe.aux_load_balance_loss(torch.from_numpy(logits),
                                          torch.from_numpy(experts), 8))
    assert got == pytest.approx(want, rel=1e-6)


def test_router_stays_f32_after_cast_for_compute():
    """cast_params_for_compute casts the experts to bf16 and leaves the
    router f32, bit for bit; the serving draw keeps it f32 too."""
    cfg = smoke_config(R.get_arch(ARCH))
    masters = T.init_params(cfg, torch.Generator().manual_seed(0))
    cast = T.cast_params_for_compute(cfg, masters)
    for name, w in cast.items():
        if name.endswith("moe/router"):
            assert w.dtype == torch.float32 and torch.equal(w, masters[name])
        elif w.ndim >= 2:
            assert w.dtype == torch.bfloat16, name
    drawn = launch.init_weights(cfg, seed=0, device="cpu", compute_dtype=True)
    assert drawn["layers/p0/moe/router"].dtype == torch.float32
    assert drawn["layers/p0/moe/w_gate"].dtype == torch.bfloat16
    assert drawn["final_norm/scale"].dtype == torch.float32
    assert T.cast_params_for_compute(cfg, drawn)["layers/p0/moe/router"].dtype \
        == torch.float32


def test_compute_dtype_draw_slices_and_leaves_dense_draws_alone():
    """The compute-dtype draw: each stacked leaf one f32 draw a period,
    scaled and cast to bf16, the router one f32 draw, the zero leaves f32;
    the dense configs' default draw stays the f32 masters'."""
    cfg = smoke_config(R.get_arch(ARCH))
    drawn = T.init_params(cfg, torch.Generator().manual_seed(5), compute_dtype=True)
    gen = torch.Generator().manual_seed(5)
    for name, d in sorted(T.schema(cfg).items()):
        got = drawn[name]
        if d.scale == 0.0:
            assert got.dtype == torch.float32 and not got.any(), name
            continue
        if T.keeps_f32(name, len(d.shape)):
            want = torch.randn(d.shape, generator=gen).mul_(d.scale)
        else:
            parts = got if name.startswith("layers/") else got[None]
            want = torch.stack([torch.randn(part.shape, generator=gen).mul_(d.scale)
                                for part in parts]).reshape(d.shape).to(torch.bfloat16)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert drawn["layers/p0/moe/router"].dtype == torch.float32
    dense = smoke_config(R.get_arch("qwen3-0.6b"))
    a = launch.init_weights(dense, seed=3, device="cpu")
    b = T.init_params(dense, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32 for k in b)


def test_active_param_count_matches_reference():
    cfg, ref = R.get_arch(ARCH), RR.get_arch(ARCH)
    assert T.param_count(cfg) == RT.param_count(ref)
    assert T.active_param_count(cfg) == RT.active_param_count(ref)
    dense = R.get_arch("qwen3-0.6b")
    assert T.active_param_count(dense) == T.param_count(dense)
