"""The port's continuous-batching scheduler (repro_torch.serve.scheduler over
repro_torch.serve.model_step) against the reference's, on smoke qwen3 and
gemma2 (windowed ring layers, window 16, so rings wrap within a few dozen
rows) with the reference's weights, in f32 activations.

Parity: one seeded trace through both packages' schedulers gives the same
greedy tokens and the same virtual-clock SLO summary (exactly: the schedule
is integer bookkeeping, and greedy tokens agree while logits differ by
~1e-5).  Compression runs at rank == head_dim, where every swap is exact
whatever Omega, so the tokens do not depend on the packages' different
Omega draws.  Then the reference's own scheduler contracts
(tests/test_scheduler.py), each on the port: backpressure, chunked prefill
that does not stall decode, staggered admission that compresses, evict and
readmit resetting sketches, factors and ring rows (bit for bit against a
fresh model), context exhaustion, the hbm_budget cap, determinism, and the
CLI's open-loop run with a saved and replayed trace and a report."""

import json

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import smoke_config as ref_smoke
from repro.models import registry as RR
from repro.models import transformer as RT
from repro.serve import loadgen as rload
from repro.serve.model_step import ModelStep as RefModelStep
from repro.serve.scheduler import Scheduler as RefScheduler
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch
from repro_torch.models import registry as R
from repro_torch.serve import loadgen
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.model_step import ModelStep
from repro_torch.serve.scheduler import QueueFullError, Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TRACE_KW = dict(prompt_short=(3, 6), prompt_long=(20, 30), max_new_range=(3, 20))
PARITY_KW = dict(slots=3, max_seq=48, kv_sketch_rank=16, kv_compress_ratio=1.0)


def _weights(arch):
    ref_cfg = ref_smoke(RR.get_arch(arch)).with_(activation_dtype="float32")
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gemma2-2b"])
def parity_run(request):
    """The same trace through the reference's scheduler and the port's."""
    ref_cfg, cfg, ref_params, params = _weights(request.param)
    trace = loadgen.generate_trace(3, 6, 500.0, vocab=cfg.vocab, **TRACE_KW)
    ref = RefScheduler(RefModelStep(ref_cfg, ref_params, **PARITY_KW),
                       prefill_chunk=4)
    ref.run(rload.generate_trace(3, 6, 500.0, vocab=cfg.vocab, **TRACE_KW))
    port = Scheduler(ModelStep(cfg, params, device="cpu", **PARITY_KW),
                     prefill_chunk=4)
    port.run(trace)
    return request.param, ref, port, len(trace)


def test_tokens_and_slo_summary_match_reference(parity_run):
    arch, ref, port, n = parity_run
    outs = sorted((r.rid, tuple(r.out), r.evicted) for r in port.finished)
    assert outs == sorted((r.rid, tuple(r.out), r.evicted) for r in ref.finished)
    assert port.metrics.summary(expected=n) == ref.metrics.summary(expected=n)
    assert port.metrics.summary(expected=n)["accounting"]["unaccounted"] == 0


def test_compression_and_rings_ran(parity_run):
    """The parity trace really swapped factors in (full-context leaves) and,
    on gemma2, wrapped the local layers' rings."""
    arch, ref, port, _ = parity_run
    # at rank == head_dim the f32 factors outweigh the bf16 rows they replace
    assert any(h["compressed_bytes"] > h["dense_bytes"]
               for h in port.metrics.hbm_samples)
    assert max(port.model._kv_comp_len) > 0
    longest = max(len(r.prompt) + len(r.out) for r in port.finished)
    assert longest > 16
    model = port.model
    assert bool(model._kv_roll_paths) == (arch == "gemma2-2b")
    assert list(model._kv_comp_len) == list(ref.model._kv_comp_len)
    assert list(model.pos) == list(ref.model.pos)


# -- bounded queue / backpressure -----------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    return cfg, launch.init_weights(cfg, seed=0, device="cpu")


def _model(cfg, params, **kw):
    return ModelStep(cfg, params, device="cpu", **kw)


def _drain(sch):
    while sch.queue or sch._live():
        sch.step()


def _live_reqs(sch):
    return [r for r in sch.active if r is not None]


def test_engine_submit_raises_queue_full(qwen):
    cfg, params = qwen
    eng = Engine(cfg, params, slots=1, max_seq=32, max_queue=2, device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    eng.submit(Request(rid=1, prompt=[3, 4], max_new=2))
    with pytest.raises(QueueFullError) as ei:
        eng.submit(Request(rid=2, prompt=[5, 6], max_new=2))
    err = ei.value
    assert err.rid == 2 and err.queue_depth == 2 and err.max_queue == 2
    assert "queue depth 2" in str(err)


def test_scheduler_reject_lands_in_metrics(qwen):
    sch = Scheduler(_model(*qwen, slots=1, max_seq=32), max_queue=1)
    assert sch.submit(0, [1, 2, 3], 2) is True
    assert sch.submit(1, [4, 5, 6], 2) is False
    assert sch.metrics.rejected == [{"rid": 1, "t_s": 0.0, "queue_depth": 1}]
    acct = sch.metrics.accounting(expected=2)
    assert acct["attempted"] == 2 and acct["unaccounted"] == 0
    with pytest.raises(ValueError, match="cannot fit max_seq"):
        sch.submit(2, list(range(40)), 2)


def test_scheduler_constructor_validation(qwen):
    model = _model(*qwen, slots=2, max_seq=32)
    with pytest.raises(ValueError, match="max_queue"):
        Scheduler(model, max_queue=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        Scheduler(model, prefill_chunk=1)
    with pytest.raises(ValueError, match="nothing could ever be admitted"):
        Scheduler(model, hbm_budget=1)


def test_solo_request_matches_engine_greedy(qwen):
    cfg, params = qwen
    prompt, max_new = [5, 9, 2, 7], 8
    eng = Engine(cfg, params, slots=2, max_seq=48, device="cpu")
    req = Request(rid=0, prompt=list(prompt), max_new=max_new)
    eng.submit(req)
    eng.run()
    sch = Scheduler(_model(cfg, params, slots=2, max_seq=48), prefill_chunk=4)
    sch.submit(0, prompt, max_new)
    _drain(sch)
    assert len(sch.finished) == 1
    assert sch.finished[0].out == req.out and len(req.out) == max_new


def test_long_prefill_does_not_stall_decode(qwen):
    sch = Scheduler(_model(*qwen, slots=2, max_seq=64), prefill_chunk=4)
    sch.submit(0, [1, 2, 3], 16)
    sch.step()
    sch.step()
    short = next(r for r in _live_reqs(sch) if r.rid == 0)
    assert short.phase == "decode" and len(short.out) >= 1
    sch.submit(1, list(range(1, 25)), 4)
    overlapped = 0
    while sch.queue or sch._live():
        long_req = next((r for r in _live_reqs(sch) if r.rid == 1), None)
        before = len(short.out)
        pre_before = long_req.prefilled if long_req else 0
        sch.step()
        if (long_req is not None and not long_req.done
                and long_req.prefilled > pre_before and len(short.out) > before):
            overlapped += 1
    assert overlapped >= 2
    assert {r.rid for r in sch.finished} == {0, 1}
    assert not any(r.evicted for r in sch.finished)


def test_staggered_admission_compresses_under_scheduler(qwen):
    """The Engine's uniform clock gaps a late slot (it never compresses);
    the scheduler's catch-up keeps every slot contiguous, so the same
    stagger keeps re-compressing."""
    cfg, params = qwen
    kw = dict(slots=2, max_seq=64, kv_sketch_rank=2, kv_compress_ratio=2.0)
    eng = Engine(cfg, params, device="cpu", **kw)
    eng.submit(Request(rid=0, prompt=[1, 2, 3, 4], max_new=20))
    for _ in range(6):
        eng.step()
    eng.submit(Request(rid=1, prompt=[5, 6, 7, 8], max_new=20))
    eng.step()
    late = next(s for s in range(2) if eng.active[s] and eng.active[s].rid == 1)
    comp_at_admit = int(eng._kv_comp_len[late])
    eng.run()
    assert not eng._kv_contig[late]
    assert int(eng._kv_comp_len[late]) == comp_at_admit
    with pytest.raises(ValueError, match="admitted mid-stream"):
        eng.compress_slot(late)

    model = _model(cfg, params, **kw)
    sch = Scheduler(model, prefill_chunk=4)
    sch.submit(0, [1, 2, 3, 4], 20)
    for _ in range(6):
        sch.step()
    sch.submit(1, [5, 6, 7, 8], 20)
    max_comp = {0: 0, 1: 0}
    while sch.queue or sch._live():
        sch.step()
        for r in _live_reqs(sch):
            max_comp[r.rid] = max(max_comp[r.rid], int(model._kv_comp_len[r.slot]))
    assert all(model._kv_contig)
    assert max_comp[0] > 4 and max_comp[1] > 4


# -- evict-then-readmit: a complete per-slot reset --------------------------

def _drive_solo(model, slot, prompt, n_new):
    logits = model.prefill_rows(slot, prompt, 0)
    out = [int(torch.argmax(logits))]
    model.auto_compress(slot)
    for _ in range(n_new - 1):
        logits = model.prefill_rows(slot, [out[-1]], int(model.pos[slot]))
        out.append(int(torch.argmax(logits)))
        model.auto_compress(slot)
    return out


def _assert_factors_equal(fa, fb):
    assert set(fa) == set(fb)
    for path in fa:
        assert torch.equal(fa[path].us, fb[path].us), path
        assert torch.equal(fa[path].vt, fb[path].vt), path


def test_evict_readmit_resets_sketches_and_factors(qwen):
    kw = dict(slots=2, max_seq=48, kv_sketch_rank=2, kv_compress_ratio=2.0)
    used = _model(*qwen, **kw)
    used.begin_slot(0)
    _drive_solo(used, 0, [3, 1, 4, 1, 5, 9, 2, 6], 14)
    assert int(used._kv_comp_len[0]) > 0
    used.begin_slot(0)
    assert int(used.pos[0]) == 0 and int(used._kv_comp_len[0]) == 0
    assert used._kv_pending[0] is None and used._kv_contig[0]
    assert int(used._kv_next_row[0]) == 0
    for path in used._kv_swap_paths:
        f = used._load_factors(0, path)
        assert not f.us.any() and not f.vt.any()
    fresh = _model(*qwen, **kw)
    fresh.begin_slot(0)
    assert _drive_solo(used, 0, [9, 4, 6, 2, 8], 10) == \
        _drive_solo(fresh, 0, [9, 4, 6, 2, 8], 10)
    _assert_factors_equal(used.kv_factors(0), fresh.kv_factors(0))
    assert used.kv_slot_bytes(0) == fresh.kv_slot_bytes(0)


def test_evict_readmit_resets_rolling_ring_gemma2():
    """gemma2's local layers keep rolling sketch rings; the previous
    tenant's ring rows and ring sketches must not leak into the next one."""
    cfg = smoke_config(R.get_arch("gemma2-2b"))
    params = launch.init_weights(cfg, seed=0, device="cpu")
    kw = dict(slots=2, max_seq=48, kv_sketch_rank=2)
    used = _model(cfg, params, **kw)
    assert used._kv_roll_paths and used._ring_paths
    used.begin_slot(0)
    _drive_solo(used, 0, [2, 4, 6, 8, 10, 12], 20)       # wraps the ring
    used.begin_slot(0)
    for path in used._ring_paths:
        assert not used._slot_leaf(path, 0).any()
    for path in used._kv_roll_paths:
        assert used._kv_sketches[0][path].rows_seen == 0
    fresh = _model(cfg, params, **kw)
    fresh.begin_slot(0)
    assert _drive_solo(used, 0, [7, 7, 3, 2], 8) == _drive_solo(fresh, 0, [7, 7, 3, 2], 8)
    _assert_factors_equal(used.kv_factors(0), fresh.kv_factors(0))
    for path in used._kv_roll_paths:
        assert torch.equal(used._kv_sketches[0][path].base.y,
                           fresh._kv_sketches[0][path].base.y)


# -- eviction at max_seq, admission, determinism -----------------------------

def test_context_exhaustion_evicts_and_is_accounted(qwen):
    sch = Scheduler(_model(*qwen, slots=1, max_seq=16), prefill_chunk=4)
    sch.submit(0, [1, 2, 3, 4], 64)
    _drain(sch)
    req = sch.finished[0]
    assert len(sch.finished) == 1 and req.evicted and len(req.out) < 64
    assert sch.metrics.accounting(expected=1) == {
        "attempted": 1, "submitted": 1, "rejected": 0, "completed": 1,
        "in_flight": 0, "evicted": 1, "unaccounted": 0}


def test_hbm_budget_caps_streams_and_compression_raises_cap(qwen):
    dense = _model(*qwen, slots=8, max_seq=64)
    budget = 3 * Scheduler(dense).stream_bound
    d_cap = Scheduler(dense, hbm_budget=budget)
    assert d_cap.max_streams == 3 and Scheduler(dense).max_streams == 8
    comp = _model(*qwen, slots=8, max_seq=64, kv_sketch_rank=2, kv_compress_ratio=2.0)
    c_cap = Scheduler(comp, hbm_budget=budget)
    assert c_cap.stream_bound < d_cap.stream_bound
    assert c_cap.max_streams > d_cap.max_streams
    # the cap holds under load: never more live streams than it allows
    sch = Scheduler(_model(*qwen, slots=8, max_seq=64), hbm_budget=budget,
                    prefill_chunk=4)
    sch.run(loadgen.generate_trace(1, 6, 1000.0, vocab=64, **TRACE_KW))
    assert sch.metrics.summary()["concurrency_max"] == 3


def test_slo_summary_deterministic_across_runs(qwen):
    cfg, params = qwen
    trace = loadgen.generate_trace(3, 6, 500.0, vocab=cfg.vocab,
                                   prompt_short=(3, 6), prompt_long=(8, 12),
                                   max_new_range=(3, 8))

    def run():
        sch = Scheduler(_model(cfg, params, slots=3, max_seq=48), prefill_chunk=4)
        sch.run(trace)
        return (sch.metrics.summary(expected=len(trace)),
                sorted((r.rid, tuple(r.out)) for r in sch.finished))
    s1, out1 = run()
    s2, out2 = run()
    assert s1 == s2 and out1 == out2
    assert s1["accounting"]["unaccounted"] == 0
    assert s1["accounting"]["in_flight"] == 0


def test_sampled_tokens_are_seeded(qwen):
    """temperature > 0 (hot: the smoke weights' logits are peaky): single-
    slot picks and batched decode draw from the model step's
    torch.Generator (a documented deviation from jax.random), so one
    sample_seed gives one token stream."""
    cfg, params = qwen
    trace = loadgen.generate_trace(4, 4, 500.0, vocab=cfg.vocab, **TRACE_KW)

    def run(seed):
        sch = Scheduler(_model(cfg, params, slots=2, max_seq=64, temperature=100.0,
                               sample_seed=seed), prefill_chunk=4)
        sch.run(trace)
        return sorted((r.rid, tuple(r.out)) for r in sch.finished)
    assert run(3) == run(3) != run(4)


def test_run_scheduler_cli_with_trace_files_and_report(tmp_path, capsys):
    """The CLI's open-loop run on the CPU: a generated trace saved, then
    replayed with --load-trace to the same report; the saved file loads in
    the reference; and run_scheduler's own record."""
    trace_path, rep1, rep2 = (str(tmp_path / n) for n in
                              ("trace.json", "r1.json", "r2.json"))
    base = ["--device", "cpu", "--smoke", "--arch", "gemma2-2b", "--slots", "2",
            "--max-seq", "64", "--kv-rank", "4", "--prefill-chunk", "8"]
    launch.main(base + ["--arrival-rate", "200", "--requests", "4",
                        "--save-trace", trace_path, "--report", rep1])
    launch.main(base + ["--load-trace", trace_path, "--report", rep2])
    out = capsys.readouterr().out
    assert "SLO summary (virtual clock)" in out and "TTFT p50 / p99" in out
    r1, r2 = (json.load(open(p)) for p in (rep1, rep2))
    assert r1["summary"] == r2["summary"] and r1["config"] == r2["config"]
    assert r1["summary"]["accounting"]["completed"] == 4
    assert r1["config"]["max_streams"] == 2
    assert len(rload.load_trace(trace_path)) == 4

    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    seen = []
    res = launch.run_scheduler(cfg, launch.init_weights(cfg, device="cpu"),
                               loadgen.load_trace(trace_path), prefill_chunk=4,
                               on_step=lambda sch, i: seen.append(i),
                               device="cpu", slots=2, max_seq=64)
    assert res["steps"] == len(res["step_ms"]) == len(res["step_kinds"]) == len(seen)
    assert res["tokens"] == res["summary"]["output_tokens"] > 0
    assert sum(p for p, _ in res["step_kinds"]) > 0
    assert sum(d for _, d in res["step_kinds"]) > 0
    assert "step" not in vars(res["scheduler"])        # the timer is removed
