"""The PyTorch port (src/repro_torch) stands alone: importing it pulls in no
jax, no ml_dtypes and nothing of the reference package; no source of it (or
chip_smoke.py) imports them; and its entry points refuse to fall back to the
CPU when CUDA is absent and the caller did not ask for the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from repro_torch import main_path, stream
from repro_torch.configs.paper_randnla import PAPER_HOSVD, PAPER_RSVD
from repro_torch.core import distributed as dist_mod
from repro_torch.core import hosvd, lstsq, projection as proj, rsvd, structured
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune, ops, shgemm_fused as kf
from repro_torch.launch import world
from repro_torch.launch.mesh import HostMesh
from repro_torch.configs.base import ShapeCfg, smoke_config
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import cache as cache_mod, registry as R
from repro_torch.serve import kv_compress, loadgen
from repro_torch.serve.engine import Engine
from repro_torch.serve.model_step import ModelStep
from repro_torch.stream import resilience as resil

torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro", "triton")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_pulls_in_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro', 'triton'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 39  # every module was imported


@pytest.mark.parametrize("sub", ["models", "serve", "stream", "launch", "data",
                                 "core", "kernels", "optim", "train",
                                 "sharding"])
def test_serving_subpackages_import_without_jax(sub):
    """Each subpackage (the serving slice's; ``stream`` with its object-store
    and resilience modules; ``data`` with the token pipelines; ``launch``
    with the mesh, the world launcher and the train launcher; ``core`` with
    the distributed layer; ``kernels`` with the autotuner; ``optim`` with
    GaLore and compression; ``train`` with the loop and its checkpoints;
    ``sharding`` with the specs and the mesh's collectives),
    imported on its own in a fresh interpreter, leaves 'jax' and 'repro'
    out of sys.modules."""
    code = (f"import importlib, pkgutil, sys\n"
            f"import repro_torch.{sub} as p\n"
            f"for m in pkgutil.walk_packages(p.__path__, 'repro_torch.{sub}.'):\n"
            f"    importlib.import_module(m.name)\n"
            f"assert 'jax' not in sys.modules\n"
            f"assert not any(n.split('.')[0] == 'repro' for n in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["repro_torch.serve.scheduler",
                                    "repro_torch.serve.loadgen",
                                    "repro_torch.serve.metrics",
                                    "repro_torch.stream.rolling",
                                    "repro_torch.launch.serve",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.dump_collectives",
                                    "repro_torch.launch.compression_dryrun"])
def test_scheduler_slice_modules_import_without_jax(module):
    """The open-loop serving slice's modules, each imported alone in a fresh
    interpreter, load no jax and nothing of the reference."""
    code = (f"import sys\n"
            f"import {module}\n"
            f"assert 'jax' not in sys.modules\n"
            f"assert not any(n.split('.')[0] == 'repro' for n in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr


def test_moe_module_imports_without_jax():
    """The routed experts' module, MLA's, the recurrent mixers' and the
    transformer that reaches them, each imported alone in a fresh
    interpreter, load no jax and nothing of the reference."""
    for module in ("repro_torch.models.moe", "repro_torch.models.mla",
                   "repro_torch.models.recurrent",
                   "repro_torch.models.transformer"):
        code = (f"import sys\n"
                f"import {module}\n"
                f"assert 'jax' not in sys.modules\n"
                f"assert not any(n.split('.')[0] == 'repro' for n in sys.modules)\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, cwd=REPO, timeout=120,
                             env={**os.environ, "PYTHONPATH": str(REPO / "src")})
        assert out.returncode == 0, (module, out.stderr)


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun",
                                    "repro_torch.launch.dump_collectives",
                                    "repro_torch.launch.compression_dryrun"])
def test_dryrun_modules_set_no_environment_variable(module):
    """The dry-run tools, imported alone in a fresh interpreter, leave the
    environment as they found it (the reference's set ``XLA_FLAGS`` at
    import, a need of jax alone) and load no jax."""
    code = (f"import os, sys\n"
            f"before = dict(os.environ)\n"
            f"import {module}\n"
            f"assert dict(os.environ) == before\n"
            f"assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno, name)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"


_A = torch.ones((4, 3))
_KEY = (0, 1)
_SMALL_RSVD = dataclasses.replace(PAPER_RSVD, n=16, rank=2)
_SMALL_HOSVD = dataclasses.replace(PAPER_HOSVD, dims=(4, 4, 4), ranks=(2, 2, 2))
_SMOKE = smoke_config(R.get_arch("qwen3-0.6b"))
_SMOKE_PARAMS = launch.init_weights(_SMOKE, device="cpu")
_SMOKE_MOE = smoke_config(R.get_arch("qwen3-moe-30b-a3b"))
ENTRY_POINTS = {
    "resolve_device": lambda **d: resolve_device(**d),
    "ops.shgemm": lambda **d: ops.shgemm(_A, torch.ones((3, 2)), **d),
    "ops.shgemm_fused": lambda **d: ops.shgemm_fused(_A, _KEY, 2, **d),
    "reference_omega": lambda **d: kf.reference_omega(_KEY, (3, 2), **d),
    "project": lambda **d: proj.project(_A, torch.ones((3, 2)), **d),
    "sketch": lambda **d: proj.sketch(_KEY, _A, 2, **d),
    "materialize_omega": lambda **d: proj.materialize_omega(_KEY, (3, 2), **d),
    "fused_omega": lambda **d: proj.fused_omega(_KEY, (3, 2), **d),
    "gaussian": lambda **d: proj.gaussian(_KEY, (3, 2), **d),
    "rsvd": lambda **d: rsvd.rsvd(_KEY, _A, 1, **d),
    "range_finder": lambda **d: rsvd.range_finder(_KEY, _A, 1, **d),
    "nystrom_eigh": lambda **d: rsvd.nystrom_eigh(_KEY, torch.eye(4), 1, **d),
    "singular_values_exp": lambda **d: rsvd.singular_values_exp(8, 2, 1e-3, **d),
    "rp_hosvd": lambda **d: hosvd.rp_hosvd(_KEY, torch.ones((4, 4, 4)), (2, 2, 2), **d),
    "rp_sthosvd": lambda **d: hosvd.rp_sthosvd(_KEY, torch.ones((4, 4, 4)), (2, 2, 2), **d),
    "lstsq": lambda **d: lstsq.sketch_precond_lstsq(_KEY, torch.ones((8, 2)), torch.ones(8), **d),
    "main_path": lambda **d: main_path.run_main_path(_SMALL_RSVD, _SMALL_HOSVD, **d),
    "init_weights": lambda **d: launch.init_weights(_SMOKE, **d),
    "build_cache": lambda **d: cache_mod.build_cache(_SMOKE, 1, 4, **d),
    "build_kv_factors": lambda **d: cache_mod.build_kv_factors(_SMOKE, 1, 4, 2, **d),
    "stream.init": lambda **d: stream.init(_KEY, 4, 2, max_rows=4, **d),
    "stream.init key-based": lambda **d: stream.init(
        _KEY, 4, 2, max_rows=4, method="shgemm_fused", left=True, **d),
    "tucker_init": lambda **d: stream.tucker_init(_KEY, (4, 4, 4), (2, 2, 2), **d),
    "rsvd_streamed": lambda **d: rsvd.rsvd_streamed(_KEY, torch.ones((8, 6)), 2, **d),
    "rp_sthosvd_streamed": lambda **d: hosvd.rp_sthosvd_streamed(
        _KEY, torch.ones((4, 4, 4)), ranks=(2, 2, 2), **d),
    "srht_sketch": lambda **d: structured.srht_sketch(_KEY, _A, 2, **d),
    "prefetch": lambda **d: list(stream.prefetch(iter([_A]), **d)),
    "elastic_distributed_rsvd_streamed": lambda **d: (
        stream.elastic_distributed_rsvd_streamed(
            _KEY, [torch.ones((4, 6)), torch.ones((4, 6))], 2, **d)),
    "distributed_rsvd_streamed": lambda **d: dist_mod.distributed_rsvd_streamed(
        _KEY, [torch.randn((4, 6)), torch.randn((4, 6))], 2,
        HostMesh((2,), ("data",)), **d),
    "autotune_blocks": lambda **d: autotune.autotune_blocks(
        8, 8, 32, time_fn=lambda *a: 1.0,
        cache_file=os.path.join(tempfile.mkdtemp(), "at.json"), **d),
    "autotune_decode_block": lambda **d: autotune.autotune_decode_block(
        1, 1, 16, 1, 8, 2, time_fn=lambda *a: 1.0,
        cache_file=os.path.join(tempfile.mkdtemp(), "at.json"), **d),
    "state_from_payload": lambda **d: resil.state_from_payload(
        *resil.state_to_payload(stream.init(_KEY, 4, 2, max_rows=4,
                                            device="cpu")), **d),
    "tucker_from_payload": lambda **d: resil.tucker_from_payload(
        *resil.tucker_to_payload(stream.tucker_init(
            _KEY, (4, 4, 4), (2, 2, 2), device="cpu")), **d),
    "run_world": lambda **d: world.run_world(
        "torch_dist_workers:fail_case", 1, kwargs={"hang": False}, **d),
    "kv_sketch_init": lambda **d: kv_compress.kv_sketch_init(_KEY, 2, 16, 8, 4, **d),
    "kv_rolling_init": lambda **d: kv_compress.kv_rolling_init(_KEY, 2, 16, 8, 4, **d),
    "rolling_init": lambda **d: stream.rolling_init(_KEY, 4, 2, window=4, **d),
    "ModelStep": lambda **d: ModelStep(_SMOKE, _SMOKE_PARAMS, slots=1, max_seq=8, **d),
    "Engine": lambda **d: Engine(_SMOKE, _SMOKE_PARAMS, slots=1, max_seq=8, **d),
    "run_engine": lambda **d: launch.run_engine(
        _SMOKE, _SMOKE_PARAMS, [[1, 2]], max_new=2, slots=1, max_seq=8, **d),
    "run_scheduler": lambda **d: launch.run_scheduler(
        _SMOKE, _SMOKE_PARAMS, [loadgen.TraceRequest(0, 0.0, [1, 2], 2)],
        slots=1, max_seq=8, **d),
    "launch.serve": lambda **d: launch.main(
        ["--smoke", "--arrival-rate", "100", "--requests", "1", "--slots", "1",
         "--max-seq", "16"] + (["--device", d["device"]] if d else [])),
    "init_weights moe": lambda **d: launch.init_weights(_SMOKE_MOE,
                                                        compute_dtype=True, **d),
    "launch.serve moe": lambda **d: launch.main(
        ["--smoke", "--arch", "qwen3-moe-30b-a3b", "--requests", "1",
         "--slots", "1", "--max-seq", "16", "--prompt-len", "4",
         "--max-new", "2", "--kv-rank", "4"]
        + (["--device", d["device"]] if d else [])),
    "launch.serve deepseek": lambda **d: launch.main(
        ["--smoke", "--arch", "deepseek-v2-lite-16b", "--requests", "1",
         "--slots", "1", "--max-seq", "16", "--prompt-len", "4",
         "--max-new", "2", "--kv-rank", "4"]
        + (["--device", d["device"]] if d else [])),
    "materialize_inputs": lambda **d: R.materialize_inputs(
        _SMOKE, ShapeCfg("s", "decode", 4, 1), 0, **d),
    "launch.train": lambda **d: launch_train.main(
        ["--smoke", "--steps", "1", "--seq", "8", "--global-batch", "2",
         "--ckpt-dir", tempfile.mkdtemp()]
        + (["--device", d["device"]] if d else [])),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_refuses_cpu_fallback(name):
    """device=None means CUDA: without CUDA it raises rather than carrying on
    on the CPU; device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](device="cuda")
    ENTRY_POINTS[name](device="cpu")


def test_kernel_wrapper_raises_for_non_cpu_non_cuda_tensor():
    from repro_torch.kernels import shgemm as k1
    a = torch.empty((32, 32), device="meta")
    b = torch.empty((32, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k1.shgemm_pallas(a, b, bm=32, bn=32, bk=32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kf.shgemm_fused_pallas(a, _KEY, 32, bm=32, bn=32, bk=32)
