"""The control of ``correct``: the reference put in the program's place in
TF32 fails a limit of each cell, where the program passes them, at sizes a
test run holds (the card's readings at the cells' own sizes are in
PERF.md; ``bench/calibrate.py`` takes them)."""

import pytest
import torch

from bench import calibrate, run

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
SMALL = {"a_exp": {"n": 1024, "rank": 128, "pool": 2},
         "algorithm3": {"dims": [64, 64, 64], "ranks": [8, 8, 8], "pool": 2}}


@pytest.fixture
def small_cells(monkeypatch):
    find = run.find_cell

    def small(spec, name):
        cell, config, traffic = find(spec, name)
        return cell, {**config, **SMALL[config["input"]]}, {**traffic,
                                                              "sample": 3}
    monkeypatch.setattr(run, "find_cell", small)
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_program_passes(small_cells, cell):
    dev = torch.device("cpu")
    _, _, traffic = run.find_cell(SPEC, cell)
    limits = traffic["limits"]
    prog = calibrate.readings(torch, dev, SPEC, cell, 2**31 + 41, 0.2)
    ctl = calibrate.readings(torch, dev, SPEC, cell, 2**31 + 42, 0.2,
                             calibrate.control_call(torch, cell, SPEC, False))
    assert all(prog[k] <= v for k, v in limits.items()), (prog, limits)
    assert any(ctl[k] > v for k, v in limits.items()), (ctl, limits)
