"""The harness finds every configuration, traffic mix and metric reader by
name, and BENCHMARK.json keeps to the contract's shape."""

import json
import re

import pytest

from bench import readers, run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    found, config, traffic = run.find_cell(SPEC, cell)
    assert found["chips"] == 1
    assert traffic["entry"] in ("rsvd", "rp_hosvd", "rp_sthosvd")
    assert set(traffic["limits"]) and all(
        isinstance(v, float) and v > 0 for v in traffic["limits"].values())
    assert config["pool"] >= 1
    for traced in (False, True):
        names = [m["name"] for m in run.cell_metrics(SPEC, cell, traced)]
        assert names, (cell, traced)
        for name in names:
            assert callable(readers.load(name))
    assert "setup_s" in [m["name"] for m in run.cell_metrics(SPEC, cell, False)]


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        run.find_cell(SPEC, "no.such.cell")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and NAME.match(c["name"])
        assert (run.ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
        # each cell it lists reports the end-to-end metric it moves
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in
                                  run.cell_metrics(SPEC, cell, False)]
    for cell in cells:
        e2e = [m["name"] for m in run.cell_metrics(SPEC, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(SPEC, cell, True)


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (run.BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_readers_on_a_trace():
    """Readers of a reduced trace: shares from the layer seconds."""
    _, config, traffic = run.find_cell(SPEC, "rsvd.fused")
    ctx = {"entry": "rsvd", "config": config, "traffic": traffic,
           "window": {"calls": 100, "seconds": 1.0},
           "trace": {"decomps": 2, "window_s": 0.02, "busy_s": 0.015,
                     "layers": {"projection": 0.6e-3, "linalg": 16e-3,
                                "other": 1e-3}}}
    assert readers.load("linalg.ms")(ctx) == pytest.approx(8.0)
    assert readers.load("densef32.ms")(ctx) == pytest.approx(0.5)
    assert readers.load("device.idle_pct")(ctx) == pytest.approx(25.0)
    # 71.5 MB / 3.35 TB/s = 21.34 us against 0.3 ms a decomposition
    assert readers.load("proj.roofline_pct")(ctx) == pytest.approx(
        100 * (71_467_008 / 3.35e12) / 0.3e-3)
    ctx["trace"]["layers"] = {}
    assert readers.load("proj.roofline_pct")(ctx) is None
    assert readers.load("linalg.ms")(ctx) is None


NAMES = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.endswith((".hosvd", ".host"))
                                  and n.rsplit(".", 1)[0] in NAMES])
def test_hosvd_metrics_read_as_their_base(name):
    """A HOSVD cells' twin (``.hosvd``, ``.host``) is its base metric's
    reading, moving a metric of its own."""
    _, config, traffic = run.find_cell(SPEC, "hosvd.st")
    ctx = {"entry": "rp_sthosvd", "config": config, "traffic": traffic,
           "window": {"calls": 700, "seconds": 1.0, "latencies_s":
                      [1e-3 * (1 + i % 7) for i in range(700)]},
           "trace": {"decomps": 4, "window_s": 0.02, "busy_s": 0.005,
                     "layers": {"projection": 0.4e-3, "linalg": 1.4e-3,
                                "other": 0.3e-3}}}
    base = name.rsplit(".", 1)[0]
    assert readers.load(name)(ctx) == readers.load(base)(ctx)


def test_busy_ms_reads_the_device_union():
    """``busy_ms.hosvd``: the traced block's busy seconds a decomposition, in
    ms; nothing where no block was traced (an untraced run off the card)."""
    read = readers.load("busy_ms.hosvd")
    assert read({"trace": {"decomps": 400, "busy_s": 0.3}}) == pytest.approx(0.75)
    assert read({"trace": None}) is None
    assert [m["source"] for m in SPEC["end_to_end"]
            if m["name"] == "busy_ms.hosvd"] == ["device_trace"]
