"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a small size, once for each fault these cells can have (no state, no batch
mean and no exchange between chips here: an answer altered where it is
produced), and for a lower-precision projection and a call that fails."""

import time

import pytest
import torch

from bench import run

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
SMALL = {"a_exp": {"n": 256, "rank": 16, "pool": 2},
         "algorithm3": {"dims": [32, 32, 32], "ranks": [4, 4, 4], "pool": 2}}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _run(cell, broken=None, **traffic_changes):
    found, config, traffic = run.find_cell(SPEC, cell)
    config = {**config, **SMALL[config["input"]]}
    traffic = {**traffic, "sample": 4, **traffic_changes}
    make = run.program_entry
    if broken is not None:
        def entry(*args):
            call = make(*args)
            return lambda key, x: broken(call(key, x))
        run.program_entry, saved = entry, run.program_entry
    try:
        return run.run_cell(torch, torch.device("cpu"), SPEC, found, config,
                            traffic, seed=2**32 + 77, seconds=0.3,
                            trace=False, t_start=time.perf_counter())
    finally:
        run.program_entry = make


def _alter(out):
    """The answer changed where it is produced: the last singular value
    doubled, or the sign of the last factor's first column flipped after
    the core was formed."""
    if len(out) == 3:
        u, s, vt = out
        s = s.clone()
        s[-1] *= 2
        return u, s, vt
    core, factors = out
    q = factors[-1].clone()
    q[:, 0] = -q[:, 0]
    return core, factors[:-1] + (q,)


def _failing_after(calls: int):
    """Calls fail from the ``calls``-th on: the warm-up passes, the window's
    calls raise."""
    seen = [0]

    def broken(out):
        seen[0] += 1
        if seen[0] > calls:
            raise RuntimeError("the kernel failed")
        return out
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["setup_parts"]) == {"start_s", "build_s", "pool_s",
                                       "warmup_s", "built"}
    assert res["setup_parts"]["built"] == []  # no card: nothing to build


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered(cell):
    res = _run(cell, _alter)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_projection(cell):
    res = _run(cell, method="lowp_single")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS[:1])
def test_failed_calls(cell):
    _, _, traffic = run.find_cell(SPEC, cell)
    res = _run(cell, _failing_after(traffic["warmup"]))
    assert not res["correct"] and res["failed"] == res["attempted"]
