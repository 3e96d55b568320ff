"""The port's load generator and SLO metrics (repro_torch.serve.loadgen,
repro_torch.serve.metrics) against the reference's: the nine cases of
tests/test_serve_loadgen.py, each run on both packages with the same inputs.
Traces must be equal for equal seeds, a saved trace file must be byte for
byte the same whichever package wrote it and load in the other, and
percentiles, records, accounting, summaries and SLO tables must be equal
(exactly: both are the same Python and numpy arithmetic)."""

import dataclasses

import pytest

from repro.serve import loadgen as rload
from repro.serve import metrics as rmetrics
from repro_torch.serve import loadgen
from repro_torch.serve import metrics


def _fields(trace):
    return [dataclasses.astuple(r) for r in trace]


# -- trace generation ------------------------------------------------------

def test_trace_deterministic_in_seed():
    a = loadgen.generate_trace(5, 40, 120.0)
    assert a == loadgen.generate_trace(5, 40, 120.0)
    assert a != loadgen.generate_trace(6, 40, 120.0)
    assert _fields(a) == _fields(rload.generate_trace(5, 40, 120.0))
    assert _fields(loadgen.generate_trace(6, 40, 120.0)) == \
        _fields(rload.generate_trace(6, 40, 120.0))


def test_trace_shape_and_distributions():
    kw = dict(vocab=64, prompt_short=(4, 12), prompt_long=(24, 48),
              long_frac=0.25, max_new_range=(4, 24))
    tr = loadgen.generate_trace(0, 200, 100.0, **kw)
    assert _fields(tr) == _fields(rload.generate_trace(0, 200, 100.0, **kw))
    assert [r.rid for r in tr] == list(range(200))
    assert tr[0].arrival_s == 0.0
    arr = [r.arrival_s for r in tr]
    assert arr == sorted(arr)
    lens = [len(r.prompt) for r in tr]
    assert all(4 <= n <= 12 or 24 <= n <= 48 for n in lens)
    assert any(n >= 24 for n in lens) and any(n <= 12 for n in lens)
    assert all(4 <= r.max_new <= 24 for r in tr)
    assert all(1 <= t < 64 for r in tr for t in r.prompt)


def test_trace_validation():
    for mod in (loadgen, rload):
        with pytest.raises(ValueError, match="n_requests"):
            mod.generate_trace(0, 0, 100.0)
        with pytest.raises(ValueError, match="arrival_rate"):
            mod.generate_trace(0, 4, 0.0)


def test_trace_roundtrip_exact_across_packages(tmp_path):
    """Saved by either package, the file's bytes are the same, and each
    package loads the other's file back to the trace."""
    tr = loadgen.generate_trace(9, 25, 300.0)
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    loadgen.save_trace(tr, str(port_path), meta={"seed": 9})
    rload.save_trace(rload.generate_trace(9, 25, 300.0), str(ref_path),
                     meta={"seed": 9})
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert loadgen.load_trace(str(port_path)) == tr
    assert loadgen.load_trace(str(ref_path)) == tr
    assert _fields(rload.load_trace(str(port_path))) == _fields(tr)


# -- percentile: nearest-rank, deterministic -------------------------------

def test_percentile_nearest_rank():
    xs = [0.1, 0.2, 0.3, 0.4]
    cases = [(xs, 50, 0.2), (xs, 99, 0.4), (xs, 0, 0.1), ([7.0], 99, 7.0),
             ([], 50, 0.0), ([0.3, 0.1, 0.9, 0.5, 0.7], 90, 0.9)]
    for values, pct, want in cases:
        assert metrics.percentile(values, pct) == want
        assert rmetrics.percentile(values, pct) == want


# -- metrics lifecycle -----------------------------------------------------

def test_request_record_slos():
    kw = dict(rid=0, submit_s=1.0, admit_s=1.5, first_token_s=2.0,
              finish_s=4.0, n_out=5)
    rec, ref = metrics.RequestRecord(**kw), rmetrics.RequestRecord(**kw)
    assert rec.ttft == ref.ttft == 1.0
    assert rec.queue_wait == ref.queue_wait == 0.5
    assert rec.latency == ref.latency == 3.0
    assert rec.tpot == ref.tpot == pytest.approx(0.5)
    assert metrics.RequestRecord(rid=1, submit_s=0.0).ttft is None
    one = dict(kw, n_out=1)
    assert metrics.RequestRecord(**one).tpot == rmetrics.RequestRecord(**one).tpot == 0.0


def _drive(m):
    m.on_submit(0, 0.0, 4, 8)
    m.on_submit(1, 0.1, 4, 8)
    m.on_reject(2, 0.2, 7)
    m.on_admit(0, 0.3)
    m.on_token(0, 0.5)
    m.on_finish(0, 0.9)
    return m


def test_metrics_accounting_conservation():
    m, ref = _drive(metrics.ServeMetrics()), _drive(rmetrics.ServeMetrics())
    acct = m.accounting(expected=3)
    assert acct == ref.accounting(expected=3)
    assert acct["attempted"] == 3 and acct["unaccounted"] == 0
    assert acct["rejected"] == 1 and acct["completed"] == 1
    assert acct["in_flight"] == 1
    assert m.accounting(expected=4)["unaccounted"] == 1
    assert m.accounting() == ref.accounting()


def _summary_run(m):
    for rid in range(3):
        m.on_submit(rid, rid * 0.1, 4, 2)
        m.on_admit(rid, rid * 0.1 + 0.05)
        m.on_token(rid, rid * 0.1 + 0.2)
        m.on_token(rid, rid * 0.1 + 0.3)
        m.on_finish(rid, rid * 0.1 + 0.3, evicted=rid == 2)
    m.sample(2, 3, hbm={"dense_bytes": 1000, "compressed_bytes": 600})
    m.sample(0, 1, hbm={"dense_bytes": 400, "compressed_bytes": 100})
    return m


def test_metrics_summary_and_table():
    s = _summary_run(metrics.ServeMetrics()).summary(expected=3)
    ref = _summary_run(rmetrics.ServeMetrics()).summary(expected=3)
    assert s == ref
    assert s["completed"] == 3 and s["output_tokens"] == 6
    assert s["ttft_p50_s"] == pytest.approx(0.2)
    assert s["tokens_per_s"] > 0
    assert s["hbm"]["headroom_bytes"] == 400
    assert s["accounting"]["unaccounted"] == 0
    table = metrics.format_slo_table(s)
    assert table == rmetrics.format_slo_table(ref)
    for label in ("tokens/sec", "TTFT p50 / p99", "queue depth",
                  "HBM headroom vs dense", "rejected (backpressure)"):
        assert label in table
    empty = metrics.ServeMetrics().summary()
    assert empty == rmetrics.ServeMetrics().summary()
    assert metrics.format_slo_table(empty) == rmetrics.format_slo_table(empty)


def test_trace_request_fields_survive_asdict():
    r = loadgen.TraceRequest(rid=3, arrival_s=0.25, prompt=[1, 2], max_new=4)
    d = dataclasses.asdict(r)
    assert d == {"rid": 3, "arrival_s": 0.25, "prompt": [1, 2], "max_new": 4}
    assert d == dataclasses.asdict(rload.TraceRequest(**d))
