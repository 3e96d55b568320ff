"""optim/ (optimizers, galore, compression) against the reference on the
same numpy inputs, and ``convert.opt_state_from_reference``.

Tolerances: AdamW, Adafactor and SGD updates and states over 3 steps at
rtol 1e-6 / atol 1e-7 (the same f32 formulas in both frameworks); GaLore's
update at ||port - reference|| / ||reference|| <= 1e-4 per leaf (the range
finder's QR runs in two LAPACK builds; column signs of P are free, so
updates are compared, never P); compression's reduced gradients and
residuals at rtol 1e-4 / atol 1e-4 (the reference's own microbatch
tolerance, tests/test_stream.py), incompressible leaves bit for bit.  The
port's keys derived by ``fold_in`` and its Gaussian Omega are patched to
the reference's words and draws (``reference_draws``); ``shgemm_fused``
needs no patch for Omega, its lattice is the reference's.

Compression rounds its orthonormal basis Q to bf16, a step function: the
two packages' Q agree to 1e-7 (two LAPACK QRs, and for ``shgemm_fused`` an
f32 lattice whose Box-Muller samples differ by an ulp between XLA's and
PyTorch's log/cos), which turns a few bf16 elements of Q the other way, and
error feedback grows what that moves (3.1e-4 after three steps).  So the
compression tests take Q from the reference (``reference_basis``) and
``test_draw_basis_matches_reference`` holds the port's Q to the
reference's through Q Q^T, which the column signs leave alone.  The
reference's Pallas methods run in interpret mode, so matrices stay at
<= 320 rows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as ref_proj
from repro.optim import compression as ref_comp
from repro.optim import galore as ref_galore
from repro.optim import optimizers as ref_opt
from repro_torch.convert import from_reference, opt_state_from_reference
from repro_torch.core import projection as proj
from repro_torch.kernels import shgemm_fused as kf
from repro_torch.launch import world
from repro_torch.optim import compression, galore
from repro_torch.optim import optimizers as opt
from repro_torch.stream import state as st_mod

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers
torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals

METHODS = ["f32", "shgemm", "shgemm_pallas", "shgemm_fused"]
OPT_SHAPES = {"w": (64, 32), "stack": (3, 16, 24), "b": (32,)}
GALORE_SHAPES = {"tall": (256, 64), "wide": (64, 128), "stack": (2, 64, 64),
                 "b": (64,)}
COMP_SHAPES = {"w": (256, 48), "w2": (320, 32), "small": (64, 64), "b": (48,)}
WORLD_TIMEOUT = 120.0


def _ref_fold_in_words(key, data):
    jkey = jnp.asarray(np.array(kf.key_pair(key), np.uint32))
    return tuple(int(w) for w in np.asarray(jax.random.fold_in(jkey, data)))


def _ref_gaussian(key, shape, dtype=torch.bfloat16, device=None):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}[dtype]
    g = ref_proj.gaussian(jnp.asarray(np.array(kf.key_pair(key), np.uint32)),
                          shape, dtype=jdt)
    return from_reference(np.asarray(g)).to(device)


def _ref_materialize(key, shape, *, dist="gaussian", s=None,
                     dtype=torch.bfloat16, device=None):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}[dtype]
    omega = ref_proj.materialize_omega(
        jnp.asarray(np.array(kf.key_pair(key), np.uint32)), shape, dist=dist,
        s=s, dtype=jdt)
    return from_reference(np.asarray(omega)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    """fold_in words := jax.random.fold_in's; the non-fused Omega and the
    compression basis's Gaussian := the reference's jax.random draws."""
    monkeypatch.setattr(st_mod, "fold_in_words", _ref_fold_in_words)
    monkeypatch.setattr(proj, "materialize_omega", _ref_materialize)
    monkeypatch.setattr(proj, "gaussian", _ref_gaussian)


@pytest.fixture
def reference_basis(reference_draws, monkeypatch):
    """The compression basis Q := the reference's for the same key words
    (module docstring)."""
    def draw(key, i, d, rank, method, device):
        q = ref_comp._draw_basis(jnp.asarray(np.array(key, np.uint32)), i, d,
                                 rank, method)
        return from_reference(np.asarray(q)).to(device)
    monkeypatch.setattr(compression, "_draw_basis", draw)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _leaves(tree, prefix=""):
    """Flat {path: leaf} of nested dicts / tuples (None skipped)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                                      else tree)
    return out


# ---------------------------------------------------------------------------
# AdamW, Adafactor, SGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_matches_reference(name):
    params = _arrays(OPT_SHAPES, 0)
    ref_tx, tx = ref_opt.get(name, 1e-2), opt.get(name, 1e-2)
    rs, ps = ref_tx.init(_j(params)), tx.init(_t(params))
    for step in range(3):
        grads = _arrays(OPT_SHAPES, 10 + step)
        ru, rs = ref_tx.update(_j(grads), rs, _j(params))
        pu, ps = tx.update(_t(grads), ps, _t(params))
        for k in params:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ru[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        want, got = _leaves(rs), _leaves(ps)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        params = {k: params[k] + np.asarray(ru[k]) for k in params}
    assert ps["t"].dtype == torch.int32 and int(ps["t"]) == 3


def test_get_unknown_optimizer():
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.get("lion", 1e-3)


def _quadratic_problem(d=128, n=512, seed=0):
    """The reference test's problem (test_substrate.py) in torch."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    w_true = torch.randn((d, d), generator=g) / np.sqrt(d)
    y = x @ w_true
    params = {"w": torch.randn((d, d), generator=g) * 0.01}

    def loss(p):
        return torch.mean((x @ p["w"] - y) ** 2)

    return params, loss


def _descend(tx, params, loss, steps, compress_rank=None):
    state = tx.init(params)
    cstate = compression.init_state(params) if compress_rank else None
    for _ in range(steps):
        w = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(w, torch.autograd.grad(loss(w), list(w.values()))))
        if compress_rank:
            grads, cstate = compression.compress_and_reduce(
                grads, cstate, rank=compress_rank)
        upd, state = tx.update(grads, state, params)
        params = {k: params[k] + upd[k] for k in params}
    return float(loss(params))


@pytest.mark.parametrize("make", [lambda: opt.adamw(1e-2), lambda: opt.adafactor(1e-2),
                                  lambda: galore.galore(1e-2, rank=32,
                                                        refresh_every=10)],
                         ids=["adamw", "adafactor", "galore"])
def test_optimizers_descend(make):
    """The reference's test_optimizers_descend: 60 steps on a quadratic
    take the loss below 0.2x its start."""
    params, loss = _quadratic_problem()
    l0 = float(loss(params))
    assert _descend(make(), params, loss, 60) < 0.2 * l0


# ---------------------------------------------------------------------------
# GaLore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_galore_matches_reference(reference_draws, method):
    """Rank 16, refresh_every=2 (refreshes at steps 1 and 3), 3 steps; a
    tall and a wide matrix get the range finder, a 3-D leaf and a vector
    plain Adam."""
    params = _arrays(GALORE_SHAPES, 1)
    kw = dict(rank=16, refresh_every=2, method=method)
    ref_tx, tx = ref_galore.galore(1e-2, **kw), galore.galore(1e-2, **kw)
    rs, ps = ref_tx.init(_j(params)), tx.init(_t(params))
    update = jax.jit(ref_tx.update)
    for step in range(3):
        grads = _arrays(GALORE_SHAPES, 20 + step)
        ru, rs = update(_j(grads), rs, _j(params))
        pu, ps = tx.update(_t(grads), ps, _t(params))
        for k in params:
            want = np.asarray(ru[k])
            rel = np.linalg.norm(pu[k].numpy() - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (method, step, k, rel)
        params = {k: params[k] + np.asarray(ru[k]) for k in params}
    assert int(ps["t"]) == 3 and ps["key"].tolist() == [0, galore.KEY_SEED]


def test_galore_refreshes_only_on_refresh_steps(monkeypatch):
    calls = []
    real = galore.rsvd_mod.range_finder

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(galore.rsvd_mod, "range_finder", counting)
    params = _t(_arrays(GALORE_SHAPES, 1))
    tx = galore.galore(1e-2, rank=16, refresh_every=2)
    st = tx.init(params)
    per_step = []
    for step in range(5):
        _, st = tx.update(_t(_arrays(GALORE_SHAPES, 30 + step)), st, params)
        per_step.append(len(calls))
    assert per_step == [2, 2, 4, 4, 6]     # two matrices, steps 1, 3, 5


def test_galore_memory_claim():
    """The reference's test_galore_memory_claim."""
    params = {"w1": torch.zeros((4096, 1024)), "w2": torch.zeros((1024, 4096)),
              "b": torch.zeros((1024,))}
    adam_b, gal_b = galore.optimizer_state_bytes(params, rank=64)
    assert gal_b < 0.2 * adam_b
    ref = ref_galore.optimizer_state_bytes(
        {k: jnp.zeros(v.shape) for k, v in params.items()}, rank=64)
    assert (adam_b, gal_b) == ref


def test_galore_state_shapes_are_low_rank():
    """The reference's test_galore_state_shapes_are_low_rank."""
    st = galore.galore(rank=32).init({"w": torch.zeros((512, 256))})
    leaf = st["leaves"]["w"]
    assert tuple(leaf.proj.shape) == (512, 32)
    assert tuple(leaf.m.shape) == (32, 256)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _assert_reduced(got, want, incompressible=("small", "b")):
    for k in want:
        if k in incompressible:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def _assert_residual(got, want):
    for k, e in want.residual.items():
        if e is None:
            assert got.residual[k] is None, k
        else:
            np.testing.assert_allclose(got.residual[k].numpy(), np.asarray(e),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("method", ["shgemm", "shgemm_fused"])
@pytest.mark.parametrize("leaf", [0, 3])
def test_draw_basis_matches_reference(reference_draws, method, leaf):
    jkey = jax.random.fold_in(jax.random.PRNGKey(42), 1)
    want = np.asarray(ref_comp._draw_basis(jkey, leaf, 320, 32, method))
    got = compression._draw_basis(tuple(int(w) for w in np.asarray(jkey)),
                                  leaf, 320, 32, method, "cpu").numpy()
    assert got.shape == want.shape == (320, 32)
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-6)
    np.testing.assert_allclose(got.T @ got, np.eye(32), atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_compress_and_reduce_matches_reference(reference_basis, method):
    """Three steps with error feedback; rank 32."""
    grads0 = _arrays(COMP_SHAPES, 2)
    rs, ps = ref_comp.init_state(_j(grads0)), compression.init_state(_t(grads0))
    assert [k for k, e in ps.residual.items() if e is None] == ["small", "b"]
    for step in range(3):
        grads = _arrays(COMP_SHAPES, 40 + step)
        rr, rs = ref_comp.compress_and_reduce(_j(grads), rs, rank=32,
                                              method=method)
        pr, ps = compression.compress_and_reduce(_t(grads), ps, rank=32,
                                                 method=method)
        _assert_reduced(pr, rr)
        _assert_residual(ps, rs)


@pytest.mark.parametrize("method", ["f32", "shgemm_fused"])
def test_microbatch_accumulation_matches_reference(reference_basis, method):
    """begin/accumulate/finish over 4 microbatches against the reference's
    and against the port's compress_and_reduce of their sum (the reference
    test's tolerance; the incompressible leaves bit for bit)."""
    grads = _arrays(COMP_SHAPES, 3)
    micro = [{k: g * (0.3 + 0.2 * j) for k, g in grads.items()}
             for j in range(4)]
    total = {k: sum(m[k] for m in micro) for k in grads}
    ps = compression.init_state(_t(grads))
    one, one_st = compression.compress_and_reduce(_t(total), ps, rank=16,
                                                  method=method)
    ms = compression.begin_accumulation(ps, _t(micro[0]), rank=16,
                                        method=method)
    for g in micro:
        ms = compression.accumulate_microbatch(ms, _t(g), method=method)
    assert int(ms.n_micro) == 4
    red, st = compression.finish_accumulation(ms)
    _assert_reduced(red, {k: v.numpy() for k, v in one.items()})
    for k, e in one_st.residual.items():
        if e is not None:
            np.testing.assert_allclose(st.residual[k].numpy(), e.numpy(),
                                       rtol=1e-4, atol=1e-4)
    rs = ref_comp.init_state(_j(grads))
    rms = ref_comp.begin_accumulation(rs, _j(micro[0]), rank=16, method=method)
    for g in micro:
        rms = ref_comp.accumulate_microbatch(rms, _j(g), method=method)
    rred, rst = ref_comp.finish_accumulation(rms)
    _assert_reduced(red, rred)
    _assert_residual(st, rst)


def test_compression_unbiased_over_time():
    """The reference's test: with error feedback the time-averaged
    compressed gradient converges to the true one at the O((d/r)/T) rate."""
    g = {"w": torch.randn((512, 64), generator=torch.Generator().manual_seed(0))}
    state = compression.init_state(g)
    steps, rank = 100, 64
    acc = torch.zeros_like(g["w"])
    for _ in range(steps):
        red, state = compression.compress_and_reduce(g, state, rank=rank)
        acc = acc + red["w"]
    rel = float(torch.linalg.norm(acc / steps - g["w"]) / torch.linalg.norm(g["w"]))
    assert rel < 2.0 * (512 / rank) / steps, rel


def test_compression_wire_bytes():
    g = {"w": torch.zeros((4096, 512)), "b": torch.zeros((64,))}
    full, comp = compression.wire_bytes(g, rank=32)
    assert comp < 0.05 * full
    assert (full, comp) == ref_comp.wire_bytes(
        {k: jnp.zeros(v.shape) for k, v in g.items()}, rank=32)


def test_compression_training_converges():
    """The reference's test: AdamW on compressed gradients still descends."""
    params, loss = _quadratic_problem(d=256)
    l0 = float(loss(params))
    assert _descend(opt.adamw(1e-2), params, loss, 60, compress_rank=64) < 0.3 * l0


# ---------------------------------------------------------------------------
# group= across a gloo world
# ---------------------------------------------------------------------------

def test_compression_group_matches_mean_of_single_process():
    """Two gloo ranks, each with its own gradients: the group result (one
    step of compress_and_reduce, and the microbatch path) equals the mean of
    the ranks' single-process g_hat (sketches are linear), the
    incompressible leaves the exact sum; each rank's residual is its own
    accumulator minus the shared g_hat."""
    n = 2
    grads = [_arrays(COMP_SHAPES, 50 + r) for r in range(n)]
    outs = world.run_world("torch_dist_workers:compression_case", n,
                           kwargs={"grads": grads, "rank_k": 16},
                           backend="gloo", device="cpu", timeout=WORLD_TIMEOUT)
    singles = []
    for g in grads:
        st = compression.init_state(_t(g))
        singles.append(compression.compress_and_reduce(_t(g), st, rank=16)[0])
    for k in COMP_SHAPES:
        if k in ("small", "b"):
            want = sum(g[k] for g in grads)
            for out in outs:
                np.testing.assert_array_equal(out["oneshot"][k].numpy(), want)
                np.testing.assert_array_equal(out["micro"][k].numpy(), want)
            continue
        want = sum(s[k] for s in singles).numpy() / n
        for r, out in enumerate(outs):
            for path in ("oneshot", "micro"):
                np.testing.assert_allclose(out[path][k].numpy(), want,
                                           rtol=1e-4, atol=1e-5, err_msg=(r, path, k))
            np.testing.assert_allclose(
                out["residual"][k].numpy(), grads[r][k] - n * want,
                rtol=1e-4, atol=1e-4)
    assert all(torch.equal(outs[0]["oneshot"][k], o["oneshot"][k])
               for o in outs[1:] for k in COMP_SHAPES)


# ---------------------------------------------------------------------------
# opt_state_from_reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd", "galore"])
def test_reference_state_continues_in_port(reference_draws, name):
    """Two reference updates, the state carried across, one port update:
    equal to the reference's third update (at the optimizers' tolerances)."""
    shapes = GALORE_SHAPES if name == "galore" else OPT_SHAPES
    if name == "galore":
        kw = dict(rank=16, refresh_every=2, method="shgemm_fused")
        ref_tx, tx = ref_galore.galore(1e-2, **kw), galore.galore(1e-2, **kw)
    else:
        ref_tx, tx = ref_opt.get(name, 1e-2), opt.get(name, 1e-2)
    params = _arrays(shapes, 4)
    rs = ref_tx.init(_j(params))
    for step in range(2):
        _, rs = ref_tx.update(_j(_arrays(shapes, 60 + step)), rs, _j(params))
    ps = opt_state_from_reference(rs, device="cpu")
    grads = _arrays(shapes, 62)
    ru, rs3 = ref_tx.update(_j(grads), rs, _j(params))
    pu, ps3 = tx.update(_t(grads), ps, _t(params))
    for k in params:
        if name == "galore":
            want = np.asarray(ru[k])
            assert np.linalg.norm(pu[k].numpy() - want) <= 1e-4 * np.linalg.norm(want)
        else:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ru[k]),
                                       rtol=1e-6, atol=1e-7)
    assert ps["t"].device.type == "cpu" and int(ps3["t"]) == 3


def test_compression_state_continues_in_port(reference_basis):
    grads0 = _arrays(COMP_SHAPES, 5)
    rs = ref_comp.init_state(_j(grads0))
    for step in range(2):
        _, rs = ref_comp.compress_and_reduce(_j(_arrays(COMP_SHAPES, 70 + step)),
                                             rs, rank=32, method="shgemm_fused")
    ps = opt_state_from_reference(rs)
    assert isinstance(ps, compression.CompressionState) and ps.residual["b"] is None
    grads = _arrays(COMP_SHAPES, 72)
    rr, rs = ref_comp.compress_and_reduce(_j(grads), rs, rank=32,
                                          method="shgemm_fused")
    pr, ps = compression.compress_and_reduce(_t(grads), ps, rank=32,
                                             method="shgemm_fused")
    _assert_reduced(pr, rr)
    _assert_residual(ps, rs)


def test_opt_state_from_reference_refuses_unknown_nodes():
    with pytest.raises(ValueError, match="unknown optimizer state"):
        opt_state_from_reference([np.zeros(2)])
