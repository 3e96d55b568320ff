"""Nothing the benchmark runs loads JAX or the JAX package, the reference
loads nothing of the program, and without the program a run cannot start."""

import json
import shutil
import subprocess
import sys

from bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded_after(code: str, cwd=None) -> set[str]:
    src = ("import sys, json\n" + code + "\n"
           "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=300, cwd=cwd or run.ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    code = ("sys.path[:0] = ['bench', '.']\n"
            "from bench import run, readers, reference, devtrace, calibrate, work\n"
            "run._environment()\n"
            "import repro_torch.core.rsvd, repro_torch.core.hosvd\n"
            "spec = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
            "for w in spec['workloads']:\n"
            "    cell, config, traffic = run.find_cell(spec, w['name'])\n"
            "    run.program_entry(traffic['entry'], config, traffic, 'cpu')\n"
            "    for m in spec['end_to_end'] + spec['per_layer']:\n"
            "        readers.load(m['name'])\n")
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_names_compare_whole():
    names = ["repro_torch", "repro_torch.core", "jax_free", "flaxen", "os"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["repro.core", "jax.numpy"]) == [
        "jax", "repro"]


def test_reference_loads_no_program():
    code = ("sys.path.insert(0, '.')\n"
            "from bench import reference, lattice, inputs, work\n")
    loaded = _loaded_after(code)
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN


def test_no_run_without_the_program(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "rsvd.fused",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.')\n"
         "from bench import run\nrun._environment()\nimport repro_torch"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "repro_torch" in out.stderr


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result
    (on a machine with a card the test has nothing to check)."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "rsvd.fused", "--seed",
         "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=run.ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_pin_to_one_cpu():
    out = subprocess.run(
        [sys.executable, "-c", "import os, sys; sys.path.insert(0, '.')\n"
         "from bench import run\nbefore = max(os.sched_getaffinity(0))\n"
         "run.pin_to_one_cpu()\nprint(sorted(os.sched_getaffinity(0)), before)"],
        capture_output=True, text=True, timeout=300, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr
    cpus, before = out.stdout.split("] ")
    assert cpus + "]" == f"[{before.strip()}]"
