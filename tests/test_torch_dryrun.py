"""The cell machinery and the dry run against the reference, on the CPU.

The per-arch config modules, ``abstract_params`` / ``abstract_cache``,
``input_specs`` and the rank-0 argument bytes are exact: they are shapes and
dtypes.  ``materialize_inputs`` cannot draw the reference's threefry bits,
so its laws are held (tree, shapes, dtypes, ranges, ``write_pos``, the
float scale within 5 %, the same seed the same bits).  ``step_for``'s steps
run both packages on the same numpy inputs and the reference's weights in
f32 activations: the train step's loss at rel 1e-5 and its params at atol
1e-5 (tests/test_torch_train.py's rule), last-position logits at the dense
archs' bound (rtol 1e-6, atol 1.6e-5, tests/test_torch_transformer.py) and,
for the recurrent archs, at tests/test_torch_recurrent.py's 1e-5.

``flops_probe``'s matmul FLOPs (``FlopCounterMode``) are held within 0.1 %
of the ``dot_general`` FLOPs a walker counts in the reference's jaxpr of the
same step at smoke size (scan bodies times their length), with two stated
differences of the port's own:

  * the port's prefill computes the logits of the last position only
    (``forward(last_only=True)``); the reference computes all and keeps the
    last, so its count has 2 * B * (S - 1) * D * V more, which the test adds;
  * xlstm-350m differs by up to 2 %: the reference writes the mLSTM
    normalizer's products (q . n and the state's sum of weighted keys) as
    ``dot_general``s, the port as elementwise products and sums, which
    ``FlopCounterMode`` does not count; the port's backward through the
    chunk's masked decay matrix runs products the reference's does not; and
    the port's sLSTM backward skips the gradient into its initial zero
    state (measured: train +1.30 %, prefill -0.38 %, decode -0.43 %).

The reference's traced steps run with ``remat=False`` (the port has no
rematerialization, so no forward product is run twice) and the 1-D
``vdot`` of its gradient norm is left out of the walk (``FlopCounterMode``
counts no ``aten.vdot``).  The reference side runs in a subprocess: its
``launch/dryrun.py`` sets ``XLA_FLAGS`` at import.
"""

import dataclasses
import importlib
import json
import math
import os
import pickle
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs.base import ShapeCfg as RShapeCfg
from repro.configs.base import shapes_for as ref_shapes_for
from repro.configs.base import smoke_config as ref_smoke
from repro.models import cache as rcache
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs.base import ShapeCfg, shapes_for, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import compression_dryrun, dryrun as D
from repro_torch.launch import dump_collectives
from repro_torch.launch.mesh import HostMesh, make_production_mesh
from repro_torch.models import cache as C
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)
torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(R.ARCHS)
MODULES = {"llava-next-34b": "llava_next_34b",
           "command-r-plus-104b": "command_r_plus_104b",
           "gemma2-2b": "gemma2_2b", "qwen3-0.6b": "qwen3_0_6b",
           "codeqwen1.5-7b": "codeqwen15_7b",
           "whisper-large-v3": "whisper_large_v3",
           "recurrentgemma-2b": "recurrentgemma_2b",
           "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
           "xlstm-350m": "xlstm_350m"}
# tests/test_arch_smoke.py's three smoke shapes
SMOKE_SHAPES = {"train": ShapeCfg("smoke_train", "train", 32, 2),
                "prefill": ShapeCfg("smoke_prefill", "prefill", 32, 2),
                "decode": ShapeCfg("smoke_decode", "decode", 16, 2)}
MESHES = {"16x16": False, "2x16x16": True}
FLOPS_REL = 1e-3
XLSTM_FLOPS_REL = 2e-2
F32_LOGITS = dict(rtol=1e-6, atol=1.6e-5)
RECURRENT_LOGITS = dict(rtol=1e-5, atol=1e-5)
DRYRUN_TIMEOUT = 300


def _ref_shape(s: ShapeCfg) -> RShapeCfg:
    return RShapeCfg(s.name, s.kind, s.seq_len, s.global_batch)


def _named(tree, path=()):
    """{"a/0/b": leaf} over dicts and tuples (None has no leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {"/".join(str(p) for p in path): tree}
    out = {}
    for k, v in items:
        out.update(_named(v, path + (k,)))
    return out


def _sig(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of meta tensors or
    ShapeDtypeStructs."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _named(tree).items()}


# ---------------------------------------------------------------------------
# The reference's numbers (a subprocess: its dryrun sets XLA_FLAGS)
# ---------------------------------------------------------------------------

_REFERENCE = r'''
import math, pickle, sys
import jax, jax.numpy as jnp
import jax.extend.core as jcore
from jax.sharding import AbstractMesh, PartitionSpec as P
from repro.configs.base import ShapeCfg, shapes_for, smoke_config
from repro.launch import dryrun as DR
from repro.models import registry as R
from repro.models import transformer as T
from repro.sharding import rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SMOKE = {"train": ShapeCfg("smoke_train", "train", 32, 2),
         "prefill": ShapeCfg("smoke_prefill", "prefill", 32, 2),
         "decode": ShapeCfg("smoke_decode", "decode", 16, 2)}


def spec_bytes(leaves, specs, mesh):
    total = 0
    for leaf, spec in zip(jax.tree.leaves(leaves), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        n = 1
        for i, d in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            n *= d // math.prod(mesh.shape[a] for a in axes)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def dot_flops(jaxpr):
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            lhs, rhs = (v.aval.shape for v in eqn.invars[:2])
            if len(lhs) >= 2 or len(rhs) >= 2:        # not a vdot
                (lc, _), _ = eqn.params["dimension_numbers"]
                total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                    lhs[i] for i in lc)
        subs = []
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(x, jcore.ClosedJaxpr):
                    subs.append(x.jaxpr)
                elif isinstance(x, jcore.Jaxpr):
                    subs.append(x)
        if not subs:
            continue
        name = eqn.primitive.name
        if name == "cond":
            total += max(dot_flops(s) for s in subs)
        elif name == "while":
            assert sum(dot_flops(s) for s in subs) == 0, "products in a while"
        else:
            mult = eqn.params["length"] if name == "scan" else 1
            total += mult * sum(dot_flops(s) for s in subs)
    return total


out = {"micro": {}, "args": {}, "flops": {}}
for arch in sorted(R.ARCHS):
    cfg = R.get_arch(arch)
    abs_p = T.abstract_params(cfg)
    for mname, (sizes, axes) in MESHES.items():
        mesh = AbstractMesh(sizes, axes)
        for shape in shapes_for(cfg):
            specs = R.input_specs(cfg, shape)
            serving = shape.kind != "train"
            b = {"params": spec_bytes(abs_p, rules.param_specs(
                     cfg, mesh, serving=serving), mesh),
                 "inputs": spec_bytes(specs, rules.batch_specs(
                     cfg, shape, mesh, specs), mesh),
                 "opt_state": 0}
            if not serving:
                out["micro"][(arch, shape.name, mname)] = (
                    DR.pick_micro_batches(cfg, shape, mesh))
                abs_o = jax.eval_shape(R.make_train_step(cfg).init_opt, abs_p)
                b["opt_state"] = spec_bytes(
                    abs_o, rules.opt_state_specs(cfg, mesh, abs_o), mesh)
            out["args"][(arch, shape.name, mname)] = b
    scfg = smoke_config(cfg).with_(remat=False)
    sp = T.abstract_params(scfg)
    for kind, shape in SMOKE.items():
        specs = R.input_specs(scfg, shape)
        step = R.step_for(scfg, shape)
        if kind == "train":
            jx = jax.make_jaxpr(step)(sp, jax.eval_shape(step.init_opt, sp), specs)
        else:
            jx = jax.make_jaxpr(step)(sp, specs)
        out["flops"][(arch, kind)] = dot_flops(jx.jaxpr)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         env=env, capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0 and "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Configs, abstract params and caches, input specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_module_matches_reference(arch):
    """configs/<arch>.py: CONFIG is the registry's, and CONFIG, SMOKE and
    SHAPES equal the reference module's field by field."""
    mod = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
    want = importlib.import_module(f"repro.configs.{MODULES[arch]}")
    assert mod.CONFIG is R.get_arch(arch)
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(want.CONFIG)
    assert dataclasses.asdict(mod.SMOKE) == dataclasses.asdict(want.SMOKE)
    assert ([dataclasses.asdict(s) for s in mod.SHAPES]
            == [dataclasses.asdict(s) for s in want.SHAPES])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_cache_match_reference(arch):
    """Full size: every parameter's name, shape and dtype, and the decode
    cache's leaf paths, shapes and dtypes at each live decode shape."""
    cfg, ref_cfg = R.get_arch(arch), RR.get_arch(arch)
    params = T.abstract_params(cfg)
    assert all(v.device.type == "meta" for v in params.values())
    assert _sig(params) == _sig(RT.abstract_params(ref_cfg))
    for shape in shapes_for(cfg):
        if shape.kind == "decode":
            b, s = shape.global_batch, shape.seq_len
            got = C.abstract_cache(cfg, b, s)
            assert _sig(got) == _sig(rcache.abstract_cache(ref_cfg, b, s))
            assert sum(math.prod(v.shape) * v.dtype.itemsize
                       for v in _named(got).values()) == C.cache_bytes(cfg, b, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Keys, shapes and dtypes of every live full-size cell and of the
    smoke config at tests/test_arch_smoke.py's three smoke shapes."""
    cells = [(R.get_arch(arch), RR.get_arch(arch), s)
             for s in shapes_for(R.get_arch(arch))]
    cells += [(smoke_config(R.get_arch(arch)), ref_smoke(RR.get_arch(arch)), s)
              for s in SMOKE_SHAPES.values()]
    assert [s.name for s in shapes_for(R.get_arch(arch))] == [
        s.name for s in ref_shapes_for(RR.get_arch(arch))]
    for cfg, ref_cfg, shape in cells:
        got = R.input_specs(cfg, shape)
        want = RR.input_specs(ref_cfg, _ref_shape(shape))
        assert list(got) == list(want), shape.name
        assert _sig(got) == _sig(want), shape.name


# ---------------------------------------------------------------------------
# materialize_inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-large-v3",
                                  "xlstm-350m", "deepseek-v2-lite-16b"])
def test_materialize_inputs_laws(arch, kind):
    """The tree, shapes and dtypes of ``input_specs``; ids in [0, vocab);
    ``write_pos`` = seq_len - 1; floats 0.01 N(0, 1) (std within 5 % on
    leaves of 4096 values or more); the same seed gives the same bits, and
    each leaf its own draw (two leaves of one shape differ)."""
    cfg = smoke_config(R.get_arch(arch))
    shape = dataclasses.replace(SMOKE_SHAPES[kind], global_batch=8)
    got = R.materialize_inputs(cfg, shape, 3, device="cpu")
    again = R.materialize_inputs(cfg, shape, 3, device="cpu")
    other = R.materialize_inputs(cfg, shape, 4, device="cpu")
    assert _sig(got) == _sig(R.input_specs(cfg, shape))
    flat, flat2, flat3 = _named(got), _named(again), _named(other)
    for name, x in flat.items():
        assert x.device.type == "cpu"
        assert torch.equal(x, flat2[name]), name
        if name == "write_pos":
            assert x.ndim == 0 and int(x) == shape.seq_len - 1
            continue
        assert not torch.equal(x, flat3[name]), name
        if x.dtype == torch.int32:
            assert 0 <= int(x.min()) and int(x.max()) < cfg.vocab, name
        elif x.numel() >= 4096:
            std = float(x.float().std())
            assert abs(std / 0.01 - 1) < 0.05, (name, std)
            assert abs(float(x.float().mean())) < 0.01 * 5 / math.sqrt(x.numel())
    same_shape = {}
    for name, x in flat.items():
        same_shape.setdefault((tuple(x.shape), x.dtype), []).append(name)
    for names in same_shape.values():
        for a, b in zip(names, names[1:]):
            assert not torch.equal(flat[a], flat[b]), (a, b)


def test_materialize_inputs_seed_folds_the_leaf_path():
    """Each leaf's generator is seeded from the seed and crc32 of its path,
    as the reference folds the crc into its key."""
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    got = R.materialize_inputs(cfg, SMOKE_SHAPES["train"], 7, device="cpu")
    gen = torch.Generator().manual_seed((7 << 31) + zlib.crc32(b"labels") % 2**31)
    want = torch.randint(0, cfg.vocab, (2, 32), generator=gen, dtype=torch.int32)
    assert torch.equal(got["labels"], want)


def test_step_for_picks_the_cells_step():
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    assert hasattr(R.step_for(cfg, SMOKE_SHAPES["train"], lr=1e-3), "init_opt")
    for kind in ("prefill", "decode"):
        assert not hasattr(R.step_for(cfg, SMOKE_SHAPES[kind]), "init_opt")


# ---------------------------------------------------------------------------
# step_for against the reference's steps on the same numpy inputs
# ---------------------------------------------------------------------------

def _numpy_inputs(cfg, shape, seed):
    rng = np.random.default_rng(seed)

    def make(name, spec):
        if name == "write_pos":
            return np.int32(shape.seq_len - 1)
        if spec.dtype == torch.int32:
            return rng.integers(0, cfg.vocab, tuple(spec.shape)).astype(np.int32)
        return (0.01 * rng.standard_normal(tuple(spec.shape))).astype(np.float32)

    return R._map_leaves(make, R.input_specs(cfg, shape))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_for_matches_reference(arch, kind):
    act = "float32"
    shape = SMOKE_SHAPES[kind]
    ref_cfg = ref_smoke(RR.get_arch(arch)).with_(activation_dtype=act)
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype=act)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    spec = R.input_specs(cfg, shape)
    dtypes = {k: v.dtype for k, v in _named(spec).items()}
    batch_np = _numpy_inputs(cfg, shape, seed=11)
    jdt = {torch.int32: jnp.int32, torch.float32: jnp.float32,
           torch.bfloat16: jnp.bfloat16}
    port_batch = R._map_leaves(lambda n, x: torch.tensor(x).to(dtypes[n]),
                               batch_np)
    ref_batch = R._map_leaves(lambda n, x: jnp.asarray(x).astype(jdt[dtypes[n]]),
                              batch_np)
    ref_step = RR.step_for(ref_cfg, _ref_shape(shape))
    step = R.step_for(cfg, shape)
    if kind == "train":
        want_p, _, want_m = jax.jit(ref_step)(ref_params,
                                              ref_step.init_opt(ref_params),
                                              ref_batch)
        p, _, m = step(params, step.init_opt(params), port_batch)
        assert float(m["loss"]) == pytest.approx(float(want_m["loss"]), rel=1e-5)
        for k, v in p.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]),
                                       atol=1e-5, err_msg=k)
        return
    want, _ = ref_step(ref_params, ref_batch)
    with torch.no_grad():
        got, _ = step(params, port_batch)
    tol = (RECURRENT_LOGITS if cfg.family in ("hybrid", "ssm") else F32_LOGITS)
    assert tuple(got.shape) == (shape.global_batch, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# The dry run's pieces against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pick_micro_batches_matches_reference(ref, arch):
    cfg = R.get_arch(arch)
    for mname, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for shape in shapes_for(cfg):
            if shape.kind == "train":
                assert (D.pick_micro_batches(cfg, shape, mesh)
                        == ref["micro"][(arch, shape.name, mname)]), mname


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_argument_bytes_match_reference(ref, arch):
    """Rank 0's slices of params, optimizer state and inputs, as the dry
    run makes them, against the bytes of the reference's
    ``param_specs`` / ``opt_state_specs`` / ``batch_specs`` on a
    ``jax.sharding.AbstractMesh`` of the same shape: exact, every live cell
    on both production meshes."""
    cfg = R.get_arch(arch)
    for mname, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for shape in shapes_for(cfg):
            args, _ = D.rank_arguments(cfg, shape, mesh, device="meta")
            got = {k: sum(math.prod(t.shape) * t.element_size()
                          for t in _named(v).values())
                   for k, v in args.items()}
            assert got == ref["args"][(arch, shape.name, mname)], (shape.name,
                                                                    mname)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_probe_matches_reference_jaxpr(ref, arch):
    cfg = smoke_config(R.get_arch(arch))
    rel = XLSTM_FLOPS_REL if arch == "xlstm-350m" else FLOPS_REL
    for kind, shape in SMOKE_SHAPES.items():
        got = D.flops_probe(cfg, shape, 1)["global_flops"]
        if kind == "prefill":    # the reference's logits at the other rows
            got += 2 * shape.global_batch * (shape.seq_len - 1) * cfg.d_model * cfg.vocab
        want = ref["flops"][(arch, kind)]
        assert want > 0 and abs(got - want) <= rel * want, (kind, got, want)


# ---------------------------------------------------------------------------
# The dry run itself
# ---------------------------------------------------------------------------

def test_dryrun_cli_cell_schema(tmp_path):
    """tests/test_dryrun_cell.py's cell through the port's CLI in a
    subprocess: the row's schema, and no world left in this process."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_DRYRUN_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--mesh", "single"],
        env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads((tmp_path / "xlstm-350m__decode_32k__16x16.json").read_text())
    assert row["devices"] == 256 and row["mesh"] == "16x16"
    assert row["flops"] and row["flops"] > 0
    assert row["probe"]["global_flops"] > 0
    assert set(row["collective_bytes"]) == set(D.COLLECTIVES)
    assert row["memory"]["argument_bytes"] > 0
    assert row["memory"]["argument_bytes"] == sum(row["memory"]["arguments"].values())
    assert row["compile_s"] is None and row["cost_analysis"] is None
    assert row["params"] == T.param_count(R.get_arch("xlstm-350m"))
    assert not dist.is_initialized()


def test_cli_exit_code_on_a_failed_cell(tmp_path, monkeypatch):
    """A failed cell writes its traceback beside the rows and exits 1."""
    monkeypatch.setenv("REPRO_TORCH_DRYRUN_DIR", str(tmp_path))

    def boom(*a, **k):
        raise RuntimeError("no")

    monkeypatch.setattr(D, "lower_cell", boom)
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                   "--mesh", "single"]) == 1
    assert (tmp_path / "qwen3-0.6b__decode_32k__16x16.err").exists()
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "long_500k"]) == 0


def test_fake_world_refuses_an_existing_world_and_cleans_up(tmp_path):
    with D.fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already has"):
            with D.fake_world(2):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with D.fake_world(2):
            raise ValueError("inside")
    assert not dist.is_initialized()


def _real_step_counts(cfg, shape, seed=0):
    """The same cell run on real CPU tensors in one process: its argument
    bytes and matmul FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode
    params = {k: torch.zeros(v.shape, dtype=v.dtype)
              for k, v in T.abstract_params(cfg).items()}
    batch = R.materialize_inputs(cfg, shape, seed, device="cpu")
    step = R.step_for(cfg, shape)
    opt = step.init_opt(params) if shape.kind == "train" else None
    args = sum(t.numel() * t.element_size()
               for t in list(params.values()) + list(_named(batch).values())
               + list(_named(opt).values()))
    with FlopCounterMode(display=False) as fc:
        D._run_step(step, shape, params, opt, batch)
    return args, fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "whisper-large-v3"])
def test_run_cell_on_one_rank_counts_the_real_step(arch, kind):
    """On a (1, 1) mesh the dry run's argument bytes are those of the real
    tensors a one-process run places and its FLOPs those FlopCounterMode
    counts on the real run, exactly; its peak lies between the arguments
    and the arguments plus every byte an op wrote."""
    cfg = smoke_config(R.get_arch(arch))
    shape = SMOKE_SHAPES[kind]
    row = D.run_cell(cfg, shape, HostMesh((1, 1)), micro_batches=1, probe=False)
    args, flops = _real_step_counts(cfg, shape)
    mem = row["memory"]
    assert mem["argument_bytes"] == args
    assert row["flops"] == flops
    assert row["devices"] == 1 and set(row["collective_bytes"]) == set(D.COLLECTIVES)
    assert mem["argument_bytes"] < mem["peak_bytes"] <= mem["argument_bytes"] + row["bytes"]
    assert mem["temp_bytes"] >= 0 and mem["output_bytes"] > 0
    assert not dist.is_initialized()


def test_run_cell_counts_collectives_by_caller():
    """A (4, 2) mesh of a smoke train cell: the ZeRO gathers of the cast
    are all-gathers from ``cast_params_for_compute``, the gradient sums
    all-reduces, and every grouped call adds up to the kind's bytes."""
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    row = D.run_cell(cfg, ShapeCfg("s", "train", 32, 8), HostMesh((4, 2)),
                     probe=False)
    calls = row["collective_calls"]
    for kind in D.COLLECTIVES:
        assert sum(c["total_bytes"] for c in calls if c["kind"] == kind) == (
            row["collective_bytes"][kind])
    callers = {c["caller"].split(" ")[-1] for c in calls}
    assert "cast_params_for_compute" in callers
    assert row["collective_bytes"]["all-gather"] > 0
    assert row["collective_bytes"]["all-reduce"] > 0
    assert row["micro_batches"] == 1


def test_dump_collectives_lists_one_cells_collectives(capsys):
    rows = dump_collectives.main(["qwen3-0.6b", "decode_32k", "3"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("qwen3-0.6b x decode_32k: mb=0")
    assert len(printed) == 1 + min(3, len(rows))
    assert rows and all(r["calls"] >= 1 for r in rows)
    assert rows == sorted(rows, key=lambda r: -r["total_bytes"])


def test_compression_dryrun_ratio_is_d_over_r():
    rows = compression_dryrun.main()
    (raw_name, raw), (sk_name, sk) = rows
    assert (raw_name, sk_name) == ("raw_psum", "sketched_psum")
    assert raw == 2 * 8192 * (4096 // 256) * 4
    assert raw / sk == 128
    assert not dist.is_initialized()
