"""The port's recurrent mixers (``repro_torch.models.recurrent``: the
depthwise causal conv, RG-LRU with its scan, mLSTM, sLSTM) against the
reference's (``repro.models.recurrent``) on the smoke configs of
recurrentgemma-2b (d_model 64, d_rnn 64, conv width 4) and xlstm-350m
(d_model 64, 4 heads, mLSTM width 128), on the same numpy inputs.

Tolerances: f32 rtol = atol = 1e-5 per element (the port's log-depth scan
pairs RG-LRU's steps in another order than ``jax.lax.associative_scan``,
and sums its einsums in another order; neither shows at this bound).  bf16:
each element within 2 bf16 ulps of the reference's value plus 2 ulps at the
largest |value| of the tensor (both frameworks round every bf16 op, but
not always the same f32 sum).  Returned states are held to the same bounds.

The cache's ``conv`` leaf: in bf16 activations it is bf16, as
``build_cache`` makes it; in f32 activations the tests give it f32, as the
reference's own leaf becomes once its first step returns an f32 state (a
bf16 leaf written in place would round the port's state and not the
reference's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import smoke_config as ref_smoke
from repro.models import recurrent as rrec
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs.base import smoke_config
from repro_torch.models import recurrent as rec
from repro_torch.models import registry as R

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
B = 2
ARCH_OF = {"rglru": "recurrentgemma-2b", "mlstm": "xlstm-350m",
           "slstm": "xlstm-350m"}
BLOCK = {"rglru": (rrec.rglru_block, rec.rglru_block),
         "mlstm": (rrec.mlstm_block, rec.mlstm_block),
         "slstm": (rrec.slstm_block, rec.slstm_block)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(mixer, act="float32", **kw):
    arch = ARCH_OF[mixer]
    return (ref_smoke(RR.get_arch(arch)).with_(activation_dtype=act, **kw),
            smoke_config(R.get_arch(arch)).with_(activation_dtype=act, **kw))


def _params(ref_cfg, mixer, seed=0, gain=1.0):
    """Numpy f32 leaves of one ``mixer`` layer at the schema's init scales
    (times ``gain``), drawn from ``seed``."""
    spec = next(s for s in ref_cfg.pattern if s.mixer == mixer)
    rng = np.random.default_rng(seed)
    return {k: (gain * d.scale * rng.standard_normal(d.shape)).astype(np.float32)
            for k, d in RT._layer_defs(ref_cfg, spec).items()
            if k.startswith(mixer if mixer != "rglru" else "rnn")}


def _x(cfg, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _state(cfg, mixer, act, seed=2):
    """A random cache of one layer: numpy f32 values and their leaf dtypes
    (state leaves f32; ``conv`` bf16 in bf16 activations, else f32)."""
    rng = np.random.default_rng(seed)
    d, w1 = cfg.d_model, cfg.rnn.conv_width - 1
    conv_dt = "bfloat16" if act == "bfloat16" else "float32"
    if mixer == "rglru":
        dr = cfg.rnn.d_rnn or d
        shapes = {"h": ((B, dr), "float32"), "conv": ((B, w1, dr), conv_dt)}
    elif mixer == "mlstm":
        di = int(cfg.rnn.mlstm_proj_factor * d)
        hd = di // cfg.n_heads
        shapes = {"c": ((B, cfg.n_heads, hd, hd), "float32"),
                  "n": ((B, cfg.n_heads, hd), "float32"),
                  "conv": ((B, w1, di), conv_dt)}
    else:
        shapes = {k: ((B, d), "float32") for k in ("h", "c", "n")}
    vals = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, (s, _) in shapes.items()}
    if mixer == "slstm":                          # a normalizer is positive
        vals["n"] = rng.uniform(0.5, 2.0, vals["n"].shape).astype(np.float32)
    return vals, {k: dt for k, (_, dt) in shapes.items()}


def _ref_cache(vals, dts):
    return {k: jnp.asarray(v).astype(JDT[dts[k]]) for k, v in vals.items()}


def _port_cache(vals, dts):
    """A copy: the port writes its cache in place, and a numpy buffer it
    shared could also back the reference's cache (jax may not copy it)."""
    return {k: torch.tensor(v, dtype=TDT[dts[k]]) for k, v in vals.items()}


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, want, act):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    if act == "float32":
        np.testing.assert_allclose(g, w, **F32)
    else:
        bound = 2 * _bf16_ulp(w) + 2 * _bf16_ulp(np.abs(w).max())
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()


def _run(mixer, act, x, *, cache=None, return_cache=False, seed=0, **kw):
    """The reference's block and the port's on the same inputs: (ref out,
    ref cache, port out, port cache)."""
    ref_cfg, cfg = _cfgs(mixer, act, **kw.pop("cfg_kw", {}))
    params = _params(ref_cfg, mixer, seed=seed, gain=kw.pop("gain", 1.0))
    rb, pb = BLOCK[mixer]
    dt = act
    ref_c = port_c = None
    if cache is not None:
        ref_c, port_c = _ref_cache(*cache), _port_cache(*cache)
    want, want_c = rb(ref_cfg, {k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x).astype(JDT[dt]), cache=ref_c,
                      return_cache=return_cache, **kw)
    got, got_c = pb(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x).to(TDT[dt]), cache=port_c,
                    return_cache=return_cache, **kw)
    if cache is not None:
        assert got_c is port_c                    # written back in place
    return want, want_c, got, got_c


# -- the depthwise causal conv -----------------------------------------------

@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv1d_matches_reference(act, with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 9, 12)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 12))).astype(np.float32)
    st = rng.standard_normal((B, 3, 12)).astype(np.float32) if with_state else None
    want, want_s = rrec.causal_conv1d(
        jnp.asarray(x).astype(JDT[act]), jnp.asarray(w).astype(JDT[act]),
        None if st is None else jnp.asarray(st).astype(jnp.bfloat16))
    got, got_s = rec.causal_conv1d(
        torch.from_numpy(x).to(TDT[act]), torch.from_numpy(w).to(TDT[act]),
        None if st is None else torch.from_numpy(st).bfloat16())
    assert got.dtype == got_s.dtype == TDT[act]
    assert tuple(got_s.shape) == (B, 3, 12)
    _close(got, want, act)
    _close(got_s, want_s, act)
    if with_state:                                # a one-token step
        want1, _ = rrec.causal_conv1d(jnp.asarray(x[:, :1]).astype(JDT[act]),
                                      jnp.asarray(w).astype(JDT[act]), want_s)
        got1, _ = rec.causal_conv1d(torch.from_numpy(x[:, :1]).to(TDT[act]),
                                    torch.from_numpy(w).to(TDT[act]), got_s)
        _close(got1, want1, act)


# -- the RG-LRU scan -----------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 64])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_rglru_scan_matches_reference(s, with_h0):
    """Gates a in (0.5, 1) carry the state across all 64 steps."""
    rng = np.random.default_rng(4 + s)
    a = rng.uniform(0.5, 1.0, (B, s, 16)).astype(np.float32)
    b = rng.standard_normal((B, s, 16)).astype(np.float32)
    h0 = rng.standard_normal((B, 16)).astype(np.float32) if with_h0 else None
    want = rrec._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                            None if h0 is None else jnp.asarray(h0))
    got = rec._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                          None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the recurrence itself, step by step in f64
    h = np.zeros((B, 16)) if h0 is None else h0.astype(np.float64)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(got.numpy()[:, -1], h, **F32)


def test_rglru_scan_does_not_underflow():
    """Gates of 0.01-0.2 over 8192 steps: a running product of a underflows
    f32 within a few hundred steps (what a cumprod/cumsum form would divide
    by), the scan's partial products do not, and h follows the recurrence
    computed step by step in f64."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.01, 0.2, (1, 8192, 4)).astype(np.float32)
    b = rng.standard_normal((1, 8192, 4)).astype(np.float32)
    h = rec._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                        torch.ones(1, 4)).numpy()
    assert np.isfinite(h).all()
    assert float(torch.cumprod(torch.from_numpy(a), 1)[0, 600].abs().max()) == 0.0
    want, ref = np.ones((1, 4)), np.empty((1, 8192, 4))
    for t in range(8192):
        want = a[:, t] * want + b[:, t]
        ref[:, t] = want
    np.testing.assert_allclose(h, ref, **F32)


# -- the blocks: prefill, chunked prefill with a cache, one-token decode ----

@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["rglru", "mlstm", "slstm"])
def test_block_prefill_matches_reference(mixer, act):
    """No cache, ``return_cache``: the output and the state it returns
    (sLSTM starts from n = 1 here)."""
    x = _x(_cfgs(mixer)[1], 20, seed=6)
    want, want_c, got, got_c = _run(mixer, act, x, return_cache=True)
    assert got.dtype == TDT[act]
    _close(got, want, act)
    assert sorted(got_c) == sorted(want_c)
    for k in want_c:
        _close(got_c[k], want_c[k], act)
    _, _, _, none = _run(mixer, act, x)
    assert none is None


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["rglru", "mlstm", "slstm"])
def test_block_chunk_with_cache_matches_reference(mixer, act):
    """A 12-token chunk from a random cached state: the output, and the
    state written into the cache's own tensors."""
    cfg = _cfgs(mixer)[1]
    cache = _state(cfg, mixer, act, seed=7)
    want, want_c, got, got_c = _run(mixer, act, _x(cfg, 12, seed=8), cache=cache)
    _close(got, want, act)
    for k in want_c:
        assert got_c[k].dtype == TDT[cache[1][k]]
        _close(got_c[k], want_c[k].astype(JDT[cache[1][k]]), act)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["rglru", "mlstm", "slstm"])
def test_block_decode_step_matches_reference(mixer, act):
    """One token on a cached state (RG-LRU's direct branch), three steps
    in a row, each step's state feeding the next."""
    cfg = _cfgs(mixer)[1]
    vals, dts = _state(cfg, mixer, act, seed=9)
    ref_cfg, cfg = _cfgs(mixer, act)
    params = _params(ref_cfg, mixer, seed=10)
    rb, pb = BLOCK[mixer]
    ref_c, port_c = _ref_cache(vals, dts), _port_cache(vals, dts)
    x = _x(cfg, 3, seed=11)
    for t in range(3):
        want, ref_c = rb(ref_cfg, {k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x[:, t:t + 1]).astype(JDT[act]),
                         cache=ref_c, return_cache=False)
        ref_c = {k: v.astype(JDT[dts[k]]) for k, v in ref_c.items()}
        got, _ = pb(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x[:, t:t + 1]).to(TDT[act]),
                    cache=port_c, return_cache=False)
        _close(got, want, act)
        for k in ref_c:
            _close(port_c[k], ref_c[k], act)


def test_chunks_then_decode_equal_one_prefill():
    """The port against itself in f32: an rglru prompt prefilled in one
    call, in chunks of 5 through a cache, and token by token agree (the
    sLSTM's no-cache start n = 1 differs from a zeroed cache's, as in the
    reference, so it is not part of this check)."""
    ref_cfg, cfg = _cfgs("rglru")
    p = {k: torch.from_numpy(v) for k, v in _params(ref_cfg, "rglru", seed=12).items()}
    x = torch.from_numpy(_x(cfg, 17, seed=13))
    whole, st = rec.rglru_block(cfg, p, x, cache=None, return_cache=True)
    for step in (5, 1):
        cache = {"h": torch.zeros(B, 64), "conv": torch.zeros(B, 3, 64)}
        outs = [rec.rglru_block(cfg, p, x[:, i:i + step], cache=cache,
                                return_cache=False)[0]
                for i in range(0, 17, step)]
        torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cache["h"], st["h"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cache["conv"], st["conv"], rtol=1e-5, atol=1e-5)


# -- mLSTM's chunking ---------------------------------------------------------

@pytest.mark.parametrize("unroll", [False, True], ids=["scan", "unrolled"])
@pytest.mark.parametrize("s", [48, 40], ids=["3 chunks", "ragged"])
@pytest.mark.parametrize("with_cache", [False, True], ids=["fresh", "cached"])
def test_mlstm_chunks_match_reference(s, unroll, with_cache):
    """Chunks of 16: 48 tokens run as three chunks carrying the state, 40
    (40 % 16 != 0) as one quadratic chunk of 40 (the reference's rule), in
    the reference's scanned and unrolled forms alike.  Gates scaled x5
    so that the forget decay matters across chunks."""
    cfg = _cfgs("mlstm")[1]
    cache = _state(cfg, "mlstm", "float32", seed=14) if with_cache else None
    want, want_c, got, got_c = _run(
        "mlstm", "float32", _x(cfg, s, seed=15), cache=cache,
        return_cache=True, chunk=16, gain=5.0,
        cfg_kw={"unroll_scans": unroll})
    _close(got, want, "float32")
    for k in want_c:
        _close(got_c[k], want_c[k], "float32")


def test_mlstm_chunk_rule_changes_the_sum_not_the_math():
    """Three chunks of 16 and one chunk of 48 are the same function: the
    port's two results agree to f32 rounding."""
    ref_cfg, cfg = _cfgs("mlstm")
    p = {k: torch.from_numpy(v) for k, v in
         _params(ref_cfg, "mlstm", seed=16, gain=5.0).items()}
    x = torch.from_numpy(_x(cfg, 48, seed=17))
    a, sa = rec.mlstm_block(cfg, p, x, cache=None, return_cache=True, chunk=16)
    b, sb = rec.mlstm_block(cfg, p, x, cache=None, return_cache=True, chunk=48)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sa["c"], sb["c"], rtol=1e-4, atol=1e-5)


# -- sLSTM ------------------------------------------------------------------

def test_slstm_start_state_differs_by_path():
    """Without a cache n starts at ones, from a built (zeroed) cache at
    zeros, in both packages: the two outputs differ, each equal to its
    reference path."""
    cfg = _cfgs("slstm")[1]
    x = _x(cfg, 6, seed=19)
    zero = ({k: np.zeros((B, cfg.d_model), np.float32) for k in ("h", "c", "n")},
            {k: "float32" for k in ("h", "c", "n")})
    want0, _, got0, _ = _run("slstm", "float32", x, seed=18)
    want1, _, got1, _ = _run("slstm", "float32", x, cache=zero, seed=18)
    _close(got0, want0, "float32")
    _close(got1, want1, "float32")
    assert not np.allclose(_f32(got0), _f32(got1), rtol=1e-3, atol=1e-4)


def test_blocks_differentiate_without_in_place_writes():
    """Autograd through every block without a cache: finite gradients of
    every weight and of the input."""
    for mixer in ("rglru", "mlstm", "slstm"):
        ref_cfg, cfg = _cfgs(mixer)
        p = {k: torch.from_numpy(v).requires_grad_()
             for k, v in _params(ref_cfg, mixer, seed=20).items()}
        x = torch.from_numpy(_x(cfg, 40, seed=21)).requires_grad_()
        out, _ = BLOCK[mixer][1](cfg, p, x, cache=None, return_cache=False)
        grads = torch.autograd.grad(out.square().sum(), [x, *p.values()])
        assert all(bool(torch.isfinite(g).all()) for g in grads), mixer
