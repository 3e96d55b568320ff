"""A metric's reader, found by the metric's name: ``read(ctx)`` of
``bench/metrics/<name>.py``, which returns the metric's value, or None where
the run holds nothing for it to read."""

from __future__ import annotations

import importlib.util
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"


def load(name: str):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
