"""kernels/autotune.py: the reference's autotuner behaviours
(``test_autotune.py``, ``test_autotune_schema.py``) on the card's tunables,
on the CPU with injected timers.

Kernels 1 and 2 tune (bm, bn, splits) at the planner's bk, kernel 4 its split
count P.  Card runs are simulated by naming a CUDA device and patching the
card name the autotuner reads (``autotune._cuda_name``); no kernel runs.
"""

import json
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_at
from repro_torch.kernels import autotune as at
from repro_torch.kernels import factored_decode as k4
from repro_torch.kernels import ops
from repro_torch.kernels import shgemm as k1
from repro_torch.kernels import shgemm_fused as k2

torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

H100 = "NVIDIA H100 80GB HBM3"
CARD = "cuda:0"
GEMM_KEY = re.compile(
    r"^(?P<backend>[a-z]+):(?P<m>\d+)x(?P<n>\d+)x(?P<k>\d+):"
    r"(?P<dtype>bfloat16|float16):t(?P<terms>\d+):(?P<variant>mat|fused)$")
FDEC_KEY = re.compile(
    r"^(?P<backend>[a-z]+):fdec:bkv(?P<bkv>\d+):s(?P<s>\d+):g(?P<g>\d+):"
    r"hd(?P<hd>\d+):r(?P<r>\d+)$")
SHIPPED = json.loads(Path(at.default_cache_path()).read_text())


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty user cache, the card named as an H100, no resolved pick.
    The tests write the file directly, as another process would, and call
    ``forget_picks`` where a pick of that shape was already resolved."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(at, "_cuda_name", lambda index: H100)
    at.forget_picks()
    yield str(path)
    at.forget_picks()


def _write(path, doc):
    Path(path).write_text(json.dumps(doc))


def test_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/elsewhere/reference.json")
    assert at.cache_path().endswith(os.path.join(".cache", "repro_torch",
                                                 "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "/x/y.json")
    assert at.cache_path() == "/x/y.json"


@pytest.mark.parametrize("fused", [False, True])
def test_key_grammar_is_the_references(fused):
    """Same grammar as the reference's keys, backend ``cuda``; the decode
    key adds the B·KV rows of kernel 4's grid."""
    key = at.cache_key(4096, 266, 4096, torch.bfloat16, 2, fused)
    assert key == ref_at.cache_key(4096, 266, 4096, jnp.bfloat16, 2, fused,
                                   backend="cuda")
    assert key == f"cuda:4096x266x4096:bfloat16:t2:{'fused' if fused else 'mat'}"
    assert at.decode_cache_key(64, 2048, 2, 128, 32) == \
        "cuda:fdec:bkv64:s2048:g2:hd128:r32"


def test_candidates_fit_the_shared_memory_budget():
    for fused in (False, True):
        smem = k2.smem_bytes if fused else k1.smem_bytes
        budget = smem(128, 32)
        cands = at.candidate_blocks(4096, 266, 4096, fused=fused,
                                    smem_budget=budget)
        assert cands
        bk = at.planned_blocks(4096, 266, 4096, fused=fused)[2]
        for bm, bn, bk_, splits in cands:
            assert bk_ == bk and (bm, bn) in k1.TILES
            assert smem(bm, bn) <= budget or (bm, bn, bk_, splits) == \
                at.planned_blocks(4096, 266, 4096, fused=fused)
            assert (4096 // bk) % splits == 0
        assert all(smem(bm, bn) <= at.SMEM_LIMIT
                   for bm, bn, _, _ in at.candidate_blocks(4096, 266, 4096,
                                                           fused=fused))


def test_candidates_shrink_to_problem_and_include_the_plan():
    for m, n, k in ((64, 64, 200), (48, 96, 200), (4096, 266, 4096),
                    (256, 32, 65536)):
        cands = at.candidate_blocks(m, n, k)
        assert at.planned_blocks(m, n, k) in cands
        for bm, bn, bk, splits in cands:
            assert bm <= max(32, -(-m // 32) * 32) and bn <= max(32, -(-n // 32) * 32)
            assert at.valid_plan((bm, bn, bk, splits), m, n, k)


def test_occupancy_filter_drops_tiles_an_sm_cannot_hold():
    """On the card kernel 1's candidates pass the CUDA occupancy
    calculator (``shgemm.blocks_per_sm`` >= 1); a tile it gives 0 for is
    not swept."""
    cands = at.candidate_blocks(4096, 266, 4096,
                                blocks_per_sm=lambda bm, bn: 0 if bm == 256 else 2)
    assert all(bm != 256 for bm, _, _, _ in cands)
    assert any(bm == 256 for bm, _, _, _ in at.candidate_blocks(4096, 266, 4096))


def test_autotune_cache_hit_skips_retiming(cache):
    """The second call is a cache hit that calls the timer zero times."""
    calls = []

    def fake_timer(m, n, k, plan, b_dtype, terms, fused):
        calls.append(plan)
        return float(plan[0] + plan[1] + plan[3])   # smallest tile, fewest splits

    plan1, hit1 = at.autotune_blocks(512, 128, 512, time_fn=fake_timer,
                                     cache_file=cache, device="cpu")
    assert not hit1 and calls
    assert plan1 == min(at.candidate_blocks(512, 128, 512),
                        key=lambda p: p[0] + p[1] + p[3])
    n_timed = len(calls)
    plan2, hit2 = at.autotune_blocks(512, 128, 512, time_fn=fake_timer,
                                     cache_file=cache, device="cpu")
    assert hit2 and plan2 == plan1 and len(calls) == n_timed
    # distinct entries per variant
    _, hit3 = at.autotune_blocks(512, 128, 512, fused=True, time_fn=fake_timer,
                                 cache_file=cache, device="cpu")
    assert not hit3
    doc = json.loads(Path(cache).read_text())
    assert len(doc) == 2
    for entry in doc.values():
        assert {"plan", "ms", "mode", "device", "planned", "swept"} <= set(entry)
        assert entry["mode"] == "plain" and entry["device"] == "cpu"


def test_autotune_real_timer_smoke(cache):
    """The default timer on the CPU times the plain versions through ops."""
    cands = [(32, 32, 128, 1), (64, 32, 128, 1)]
    plan, hit = at.autotune_blocks(48, 40, 128, candidates=cands,
                                   cache_file=cache, device="cpu")
    assert not hit and plan in cands
    plan2, hit2 = at.autotune_blocks(48, 40, 128, candidates=cands,
                                     cache_file=cache, device="cpu")
    assert hit2 and plan2 == plan
    p, hit = at.autotune_decode_block(1, 2, 64, 2, 16, 4, candidates=[1, 2],
                                      cache_file=cache, device="cpu")
    assert not hit and p in (1, 2)


def test_pick_blocks_uses_cache(cache):
    """ops-level plan selection serves a tuned entry and falls back to the
    planner on a miss."""
    m, n, k = 48, 96, 1024
    assert at.pick_blocks(m, n, k, device="cpu") == ops.shgemm_plan(m, n, k)
    tuned = (32, 64, 256, 2)
    at.autotune_blocks(m, n, k, candidates=[tuned], time_fn=lambda *a: 1.0,
                       cache_file=cache, device="cpu")
    assert at.pick_blocks(m, n, k, device="cpu") == tuned
    # the variant key is distinct: the fused path keeps its planner
    assert at.pick_blocks(m, n, k, fused=True, device="cpu") == ops.fused_plan(m, n, k)


def test_plain_entries_refused_on_the_card(cache):
    """A CPU run's entries are tagged ``plain`` and never served to a card;
    a card's own ``compiled`` entry is."""
    m, n, k = 48, 96, 1024
    tuned = (32, 64, 256, 2)
    at.autotune_blocks(m, n, k, candidates=[tuned], time_fn=lambda *a: 1.0,
                       cache_file=cache, device="cpu")
    entry = json.loads(Path(cache).read_text())[at.cache_key(
        m, n, k, torch.bfloat16, 2, False)]
    assert entry["mode"] == "plain"
    assert at.pick_blocks(m, n, k, device="cpu") == tuned
    assert at.pick_blocks(m, n, k, device=CARD) == ops.shgemm_plan(m, n, k)
    entry.update(mode="compiled", device=H100)
    _write(cache, {at.cache_key(m, n, k, torch.bfloat16, 2, False): entry})
    at.forget_picks()
    assert at.pick_blocks(m, n, k, device=CARD) == tuned


@pytest.mark.parametrize("entry", [
    {"plan": [32, 64, 256, 2]},                                    # untagged
    {"plan": [32, 64, 256, 2], "mode": "compiled"},                 # no device
    {"plan": [32, 64, 256, 2], "mode": "compiled",
     "device": "NVIDIA H100 PCIe"},                                 # another card
    {"plan": [32, 64, 256, 2], "mode": "shipped",
     "device": "NVIDIA A100-SXM4-80GB"},
    {"plan": [32, 64, 128, 2], "mode": "compiled", "device": H100},  # other bk
    {"plan": [32, 64, 256, 3], "mode": "compiled", "device": H100},  # bad splits
    {"plan": [48, 64, 256, 1], "mode": "compiled", "device": H100},  # no such tile
], ids=["untagged", "no-device", "h100-pcie", "a100", "bk", "splits", "tile"])
def test_unusable_entries_are_not_served(cache, entry):
    m, n, k = 48, 96, 1024
    _write(cache, {at.cache_key(m, n, k, torch.bfloat16, 2, False): entry})
    assert at.pick_blocks(m, n, k, device=CARD) == ops.shgemm_plan(m, n, k)


def test_cache_reparsed_only_when_the_file_changes(cache):
    _write(cache, {"a": {"plan": [1, 2, 3, 4]}})
    first = at._load_cache(cache)
    assert at._load_cache(cache) is first            # memoized
    _write(cache, {"a": {"plan": [1, 2, 3, 4]}, "b": {}})
    assert set(at._load_cache(cache)) == {"a", "b"}  # size changed: re-read
    assert at._load_cache(cache + ".missing") == {}


def test_picks_resolved_once_per_process(cache, monkeypatch):
    """A pick reads the files once per shape: another process's write is
    seen after ``forget_picks``; this process's own ``autotune_*`` writes
    at once."""
    m, n, k = 48, 96, 1024
    key = at.cache_key(m, n, k, torch.bfloat16, 2, False)
    assert at.pick_blocks(m, n, k, device=CARD) == ops.shgemm_plan(m, n, k)
    _write(cache, {key: {"plan": [32, 64, 256, 2], "mode": "compiled",
                         "device": H100}})
    loads = []
    monkeypatch.setattr(at, "_load_cache",
                        lambda path, real=at._load_cache: loads.append(path)
                        or real(path))
    assert at.pick_blocks(m, n, k, device=CARD) == ops.shgemm_plan(m, n, k)
    assert loads == []                               # no file read
    at.forget_picks()
    assert at.pick_blocks(m, n, k, device=CARD) == (32, 64, 256, 2)
    at.autotune_blocks(m, n, k, candidates=[(64, 32, 256, 4)],
                       time_fn=lambda *a: 1.0, force=True, device="cpu")
    assert at.pick_blocks(m, n, k, device="cpu") == (64, 32, 256, 4)


def test_sweep_keeps_another_writers_entries(cache):
    """A sweep re-reads the file before it saves: an entry another process
    wrote since this one last read the file survives it."""
    m, n, k = 48, 96, 1024
    at.autotune_blocks(m, n, k, candidates=[(32, 64, 256, 2)],
                       time_fn=lambda *a: 1.0, device="cpu")
    doc = json.loads(Path(cache).read_text())
    other = at.cache_key(64, 64, 512, torch.bfloat16, 2, False)
    doc[other] = {"plan": [32, 32, 256, 1], "mode": "compiled", "device": H100}
    _write(cache, doc)                               # the other writer
    at.autotune_blocks(m, n, k, fused=True, candidates=[(32, 64, 256, 4)],
                       time_fn=lambda *a: 1.0, device="cpu")
    assert set(json.loads(Path(cache).read_text())) == {
        at.cache_key(m, n, k, torch.bfloat16, 2, False), other,
        at.cache_key(m, n, k, torch.bfloat16, 2, True)}


def test_ops_runs_the_tuned_plan(cache, monkeypatch):
    """``ops.shgemm`` / ``ops.shgemm_fused`` launch the tuned plan when no
    ``blocks=`` / ``splits=`` is given, the caller's otherwise."""
    seen = []

    def spy(a, b, *, bm, bn, bk, splits, terms):
        seen.append((bm, bn, bk, splits))
        return k1.shgemm_plain(a, b, terms)
    monkeypatch.setattr(k1, "shgemm_pallas", spy)
    m, n, k = 48, 96, 1024
    tuned = (32, 64, 256, 2)
    at.autotune_blocks(m, n, k, candidates=[tuned], time_fn=lambda *a: 1.0,
                       cache_file=cache, device="cpu")
    a = torch.randn(m, k)
    b = torch.randn(k, n).to(torch.bfloat16)
    want = ops.shgemm(a, b, blocks=(32, 32, 256), device="cpu")
    got = ops.shgemm(a, b, device="cpu")
    assert seen == [(32, 32, 256, ops.plan_splits(m, n, k, (32, 32, 256), 3)),
                    tuned]
    assert torch.equal(got, want)
    ops.shgemm(a, b, splits=1, device="cpu")
    assert seen[-1] == ops.shgemm_plan(m, n, k)[:3] + (1,)


def test_ops_fused_runs_the_tuned_plan(cache, monkeypatch):
    seen = []
    real = k2.shgemm_fused_pallas

    def spy(a, words, n, *, bm, bn, bk, splits, **kw):
        seen.append((bm, bn, bk, splits))
        return real(a, words, n, bm=bm, bn=bn, bk=bk, splits=splits, **kw)
    monkeypatch.setattr(k2, "shgemm_fused_pallas", spy)
    m, n, k = 48, 96, 1024
    tuned = (32, 64, 256, 4)
    at.autotune_blocks(m, n, k, fused=True, candidates=[tuned],
                       time_fn=lambda *a: 1.0, cache_file=cache, device="cpu")
    a = torch.randn(m, k)
    got = ops.shgemm_fused(a, (0, 3), n, device="cpu")
    assert seen == [tuned]
    assert torch.equal(got, ops.shgemm_fused(a, (0, 3), n, blocks=(32, 32, 256),
                                             device="cpu"))


# --------------------------------------------------------------------------
# Kernel 4: P
# --------------------------------------------------------------------------

ENGINE = (8, 8, 2048, 2, 128, 32)      # b, kvh, s, g, hd, r
WIDE = (8, 8, 4096, 56, 256, 128)      # at most 60 splits fit shared memory


def test_decode_candidates_are_launchable():
    cands = at.candidate_decode_blocks(*ENGINE)
    assert at.planned_decode_block(*ENGINE) in cands
    for p in cands:
        k4.decode_plan(8, 8, 2048, 128, 32, 2, splits=p)     # does not raise
    # a short cache: at most one split a grain of rows
    assert max(at.candidate_decode_blocks(1, 2, 20, 2, 16, 4)) <= 3
    # a group so wide that P's merge state overflows shared memory at P > 60
    wide = at.candidate_decode_blocks(*WIDE)
    assert 48 in wide and 64 not in wide
    assert all(k4.smem_bytes(56, 256, 128, p, 2) <= k4.SMEM_LIMIT for p in wide)


def test_autotune_decode_block_cache_and_mode(cache):
    calls = []

    def fake_timer(b, kvh, s, g, hd, r, p):
        calls.append(p)
        return float(abs(p - 12))            # prefer P = 12

    p, hit = at.autotune_decode_block(*ENGINE, time_fn=fake_timer,
                                      cache_file=cache, device="cpu")
    assert not hit and p == 12
    n_timed = len(calls)
    p2, hit2 = at.autotune_decode_block(*ENGINE, time_fn=fake_timer,
                                        cache_file=cache, device="cpu")
    assert hit2 and p2 == 12 and len(calls) == n_timed
    # the plain entry serves a plain pick, not a card's
    assert at.pick_decode_block(*ENGINE, device="cpu") == 12
    assert at.pick_decode_block(*ENGINE, device=CARD) == \
        at.planned_decode_block(*ENGINE)


def test_pick_decode_block_is_resolved_once_per_shape(cache):
    """A cache file that changes mid-run does not change P under a captured
    graph: the first pick of a shape holds until ``forget_picks``."""
    key = at.decode_cache_key(64, 2048, 2, 128, 32)
    _write(cache, {key: {"splits": 6, "mode": "compiled", "device": H100}})
    assert at.pick_decode_block(*ENGINE, device=CARD) == 6
    _write(cache, {key: {"splits": 24, "mode": "compiled", "device": H100}})
    assert at.pick_decode_block(*ENGINE, device=CARD) == 6
    at.forget_picks()
    assert at.pick_decode_block(*ENGINE, device=CARD) == 24


def test_pick_decode_block_refuses_unlaunchable_p(cache):
    """A tuned P whose merge state overflows shared memory at this cache's
    element size falls back to the planner's."""
    key = at.decode_cache_key(64, 4096, 56, 256, 128)
    _write(cache, {key: {"splits": 64, "mode": "compiled", "device": H100}})
    assert at.pick_decode_block(*WIDE, device=CARD) == \
        at.planned_decode_block(*WIDE) == 8


def test_ops_decode_takes_p_from_the_autotuner(cache, monkeypatch):
    seen = []

    def spy(*args, splits=None, block_kv=None, **kw):
        seen.append((splits, block_kv))
        return args[0]
    monkeypatch.setattr(k4, "factored_decode_attention", spy)
    key = at.decode_cache_key(2, 16, 2, 8, 4)
    _write(cache, {key: {"splits": 2, "mode": "plain", "device": "cpu"}})
    q = torch.zeros(1, 1, 4, 8)
    kv = torch.zeros(1, 16, 2, 8)
    us, vt = torch.zeros(1, 2, 16, 4), torch.zeros(1, 2, 4, 8)
    args = (q, kv, kv, us, vt, us, vt, torch.zeros(1), 3)
    ops.factored_decode_attention(*args, scale=1.0)
    ops.factored_decode_attention(*args, scale=1.0, splits=5)
    ops.factored_decode_attention(*args, scale=1.0, block_kv=16)
    assert seen == [(2, None), (5, None), (None, 16)]


# --------------------------------------------------------------------------
# The shipped cache (test_autotune_schema.py's checks, for the card)
# --------------------------------------------------------------------------

def _parsed():
    for key, entry in SHIPPED.items():
        yield key, entry, GEMM_KEY.match(key) or FDEC_KEY.match(key)


def test_shipped_cache_covers_the_main_path():
    keys = set(SHIPPED)
    for m, n, k in ((4096, 266, 4096), (256, 32, 65536)):
        for fused in (False, True):
            assert at.cache_key(m, n, k, torch.bfloat16, 2, fused) in keys
    assert at.decode_cache_key(64, 2048, 2, 128, 32) in keys


def test_shipped_keys_parse_and_round_trip():
    for key, entry, m in _parsed():
        assert m is not None, key
        g = m.groupdict()
        assert g["backend"] == "cuda", key
        if m.re is GEMM_KEY:
            rebuilt = at.cache_key(int(g["m"]), int(g["n"]), int(g["k"]),
                                   getattr(torch, g["dtype"]), int(g["terms"]),
                                   g["variant"] == "fused")
        else:
            rebuilt = at.decode_cache_key(int(g["bkv"]), int(g["s"]),
                                          int(g["g"]), int(g["hd"]), int(g["r"]))
        assert rebuilt == key


def test_shipped_entries_are_h100_card_timings():
    """Only card timings: tagged ``shipped``, naming an H100 and its power
    limit, with the sweep they came from; none is a TPU's."""
    for key, entry, m in _parsed():
        assert entry["mode"] == "shipped", key
        assert "H100" in entry["device"], key
        assert "W" in entry["note"] and "autotune --ship" in entry["note"], key
        assert entry["ms"] > 0 and entry["swept"], key
        assert not key.startswith("tpu"), key
        assert at._entry_usable(entry, "compiled", entry["device"])


def test_shipped_plans_are_valid():
    for key, entry, m in _parsed():
        g = m.groupdict()
        if m.re is GEMM_KEY:
            mm, n, k = int(g["m"]), int(g["n"]), int(g["k"])
            fused = g["variant"] == "fused"
            assert at.valid_plan(entry["plan"], mm, n, k, terms=int(g["terms"]),
                                 fused=fused), key
            smem = k2.smem_bytes if fused else k1.smem_bytes
            assert smem(*entry["plan"][:2]) <= at.SMEM_LIMIT, key
            assert entry["planned"] == list(at.planned_blocks(
                mm, n, k, terms=int(g["terms"]), fused=fused)), key
        else:
            p = entry["splits"]
            assert p >= 1 and at._decode_fits(p, int(g["g"]), int(g["hd"]),
                                              int(g["r"]), 2), key


def test_shipped_entries_served_on_their_card(cache, monkeypatch):
    """With an empty user cache, the card the entries name gets them."""
    for key, entry, m in _parsed():
        monkeypatch.setattr(at, "_cuda_name", lambda i, d=entry["device"]: d)
        at.forget_picks()
        g = m.groupdict()
        if m.re is GEMM_KEY:
            got = at.pick_blocks(int(g["m"]), int(g["n"]), int(g["k"]),
                                 terms=int(g["terms"]),
                                 fused=g["variant"] == "fused", device=CARD)
            assert got == tuple(entry["plan"]), key
        else:
            bkv = int(g["bkv"])
            got = at.pick_decode_block(bkv, 1, int(g["s"]), int(g["g"]),
                                       int(g["hd"]), int(g["r"]), device=CARD)
            assert got == entry["splits"], key


def test_shipped_entries_not_served_to_another_card(cache, monkeypatch):
    monkeypatch.setattr(at, "_cuda_name", lambda i: "NVIDIA H100 PCIe")
    for key, entry, m in _parsed():
        if m.re is GEMM_KEY:
            g = m.groupdict()
            args = (int(g["m"]), int(g["n"]), int(g["k"]))
            assert at.pick_blocks(*args, fused=g["variant"] == "fused",
                                  device=CARD) == at.planned_blocks(
                                      *args, fused=g["variant"] == "fused")


def test_tuned_plans_give_the_planners_bits_on_the_cpu():
    """Every candidate at one bk: the plain version ignores the plan, so the
    bits are the planner's (on the card: test_torch_cuda.py)."""
    gen = np.random.default_rng(0)
    a = torch.from_numpy(gen.standard_normal((40, 200)).astype(np.float32))
    b = torch.from_numpy(gen.standard_normal((200, 72)).astype(np.float32)).to(torch.bfloat16)
    want = ops.shgemm(a, b, device="cpu")
    for bm, bn, bk, splits in at.candidate_blocks(40, 72, 200):
        got = ops.shgemm(a, b, blocks=(bm, bn, bk), splits=splits, device="cpu")
        assert torch.equal(got, want)
