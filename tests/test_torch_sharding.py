"""Training and serving across processes (``repro_torch.sharding``, the mesh
branches of ``models/``, ``optim/``, ``train/`` and ``launch/train.py``)
against the reference's mesh paths, on the same numpy inputs.

The reference runs once in a subprocess with 8 virtual CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before JAX
starts) on meshes built with Auto axes: under jax 0.9.0 ``jax.make_mesh``
gives Explicit axes, which the reference's ``with_sharding_constraint``
refuses.  Its outputs come back as numpy in a pickle.  The port runs in
gloo worlds of local processes on the CPU (``launch.world.run_world``),
each world once per module fixture; the ranks' code is in the jax-free
``torch_shard_workers.py``.

Tolerances: specs equal as tuples.  Vocab-parallel loss rtol 2e-5 and each
gradient within 2e-2 of its largest element (``tests/test_vocab_parallel.
py``'s bounds), in f32 activations across the packages (their bf16 ops
round apart: ``test_torch_train.py`` holds bf16 parity at 1e-2) and in bf16
within the port against its one-process step; tensor parallelism on, the
loss at rtol 5e-4.  Expert parallelism in f32 activations at
``test_torch_moe.py``'s f32 bound (rtol 1e-6, atol 1.6e-5) against the
reference's mesh run, grad norms at rtol 1e-5.  Sharded optimizer steps at
the f32 bound against the one-process step.  Checkpoints, ``remesh`` and
the converted weights bit for bit.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import world
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import cache as C
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.sharding import activation as A
from repro_torch.sharding import rules
from repro_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240.0     # a deadlocked collective fails its test
ARCHS = sorted(R.ARCHS)
MESHES = ((1, 2), (2, 2), (4, 2))
F32_BOUND = dict(rtol=1e-6, atol=1.6e-5)
MOE = "qwen3-moe-30b-a3b"

_REFERENCE = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs.base import smoke_config, shapes_for
    from repro.models import registry as R, transformer as T
    from repro.optim import optimizers as O
    from repro.sharding import activation as A, rules
    from repro.train.checkpoint import CheckpointManager

    assert len(jax.devices()) == 8

    def mesh(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    def named(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): tuple(v) for path, v in flat}

    def npy(tree):
        return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)

    out = {"specs": {}, "batch_shapes": {}}
    for arch in sorted(R.ARCHS):
        cfg = R.get_arch(arch)
        abstract = {k: jax.ShapeDtypeStruct(d.shape, jnp.float32)
                    for k, d in T.schema(cfg).items()}
        for shape in ((1, 2), (2, 2), (4, 2)):
            m = mesh(shape)
            for serving in (False, True):
                out["specs"][(arch, shape, "params", serving)] = named(
                    rules.param_specs(cfg, m, serving=serving))
            for opt in ("adamw", "adafactor", "sgd"):
                st = jax.eval_shape(O.get(opt, 1e-3).init, abstract)
                out["specs"][(arch, shape, "opt", opt)] = named(
                    rules.opt_state_specs(cfg, m, st))
            for cell in shapes_for(cfg):
                inputs = R.input_specs(cfg, cell)
                out["specs"][(arch, shape, "batch", cell.name)] = named(
                    rules.batch_specs(cfg, cell, m, inputs))
                out["batch_shapes"][(arch, cell.name)] = named(jax.tree.map(
                    lambda s: P(*s.shape), inputs))

    def loss_fn(cfg):
        def loss(p, b):
            return T.loss_fn(cfg, T.cast_params_for_compute(cfg, p), b)
        return loss

    # vocab-parallel loss and gradients: tests/test_vocab_parallel.py's
    # setup, in f32 activations
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    batch = {"tokens": jax.random.randint(key, (8, 16), 0, cfg.vocab, jnp.int32),
             "labels": jax.random.randint(jax.random.fold_in(key, 1), (8, 16),
                                          0, cfg.vocab, jnp.int32)}
    vg = jax.value_and_grad(loss_fn(cfg))
    A.set_mesh(None)
    l0, g0 = vg(params, batch)
    A.set_mesh(mesh((4, 2)), tp=False)
    l1, g1 = vg(params, batch)
    A.set_mesh(mesh((4, 2)), tp=True)
    l2 = loss_fn(cfg)(params, batch)
    A.set_mesh(None)
    out["vp"] = {"params": npy(params), "batch": npy(batch), "loss": float(l0),
                 "grads": npy(g0), "loss_mesh": float(l1),
                 "grads_mesh": npy(g1), "loss_tp": float(l2)}
    CheckpointManager(sys.argv[2]).save(3, params, blocking=True)

    # expert parallelism: the forward and one AdamW step, f32 activations
    cfg = smoke_config(R.get_arch("qwen3-moe-30b-a3b")).with_(
        activation_dtype="float32")
    params = T.init_params(cfg, jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(3)
    batch = {"tokens": jax.random.randint(key, (4, 16), 0, cfg.vocab, jnp.int32),
             "labels": jax.random.randint(jax.random.fold_in(key, 1), (4, 16),
                                          0, cfg.vocab, jnp.int32)}
    moe = {"params": npy(params), "batch": npy(batch)}
    for shape in (None, (1, 2), (2, 2)):
        # fresh functions a mesh: jit caches a trace by function, and the
        # mesh is global state outside its key
        step = R.make_train_step(cfg, "adamw", lr=1e-3)
        A.set_mesh(None if shape is None else mesh(shape), tp=False)
        fwd = jax.jit(lambda p, t: T.forward(
            cfg, T.cast_params_for_compute(cfg, p), t).logits)
        lg = fwd(params, batch["tokens"])
        new, _, met = jax.jit(step)(params, step.init_opt(params), batch)
        moe[shape] = {"logits": np.asarray(lg, np.float32),
                      "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "params": npy(new)}
        A.set_mesh(None)
    out["moe"] = moe
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "ref.pkl"),
                          str(tmp / "ckpt")], env=env, capture_output=True,
                         text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0 and "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        doc = pickle.load(f)
    doc["ckpt"] = tmp / "ckpt"
    return doc


def _run(fn, n, **kwargs):
    return world.run_world(f"torch_shard_workers:{fn}", n, kwargs=kwargs,
                           device="cpu", timeout=WORLD_TIMEOUT)


def _ints(batch):
    return {k: np.asarray(v).astype(np.int64) for k, v in batch.items()}


def _maxnorm_rel(got, want):
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _named(tree, path=(), seqs=False):
    """{"a/0/b": leaf} of a tree of dicts (and of tuples and lists with
    ``seqs``; else they are leaves, as specs are)."""
    if isinstance(tree, dict) or (seqs and isinstance(tree, (tuple, list))):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_named(v, path + (k,), seqs))
        return out
    if tree is None:
        return {}
    return {"/".join(str(p) for p in path): tree}


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(ref, arch, shape, serving):
    got = rules.param_specs(R.get_arch(arch), HostMesh(shape), serving=serving)
    assert got == ref["specs"][(arch, shape, "params", serving)]


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_and_batch_specs_match_reference(ref, arch, shape):
    cfg = R.get_arch(arch)
    mesh = HostMesh(shape)
    meta = {k: torch.empty(d.shape, device="meta")
            for k, d in T.schema(cfg).items()}
    for name in ("adamw", "adafactor", "sgd"):
        state = O.get(name, 1e-3).init(meta)
        got = _named(rules.opt_state_specs(cfg, mesh, state))
        assert got == ref["specs"][(arch, shape, "opt", name)], name
    cells = [c for (a, c) in ref["batch_shapes"] if a == arch]
    assert cells
    for cell in cells:
        shapes = ref["batch_shapes"][(arch, cell)]
        inputs = {}
        for name, dims in shapes.items():        # the reference's tree by path
            *parents, leaf = name.split("/")
            node = inputs
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.empty(dims, device="meta")
        got = _named(rules.batch_specs(cfg, None, mesh, inputs))
        assert got == ref["specs"][(arch, shape, "batch", cell)], cell


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "deepseek-v2-lite-16b", "whisper-large-v3"])
def test_port_cache_tree_is_the_references(ref, arch):
    """The decode cell's inputs that ``batch_specs`` was held on above name
    the port's own cache tree: the same paths and shapes."""
    cfg = R.get_arch(arch)
    shapes = ref["batch_shapes"][(arch, "decode_32k")]
    b = shapes["tokens"][0]
    cache = C._build_layer_trees(
        cfg, lambda spec: C._layer_cache_defs(cfg, spec, b, 32768),
        lambda shape, dt: torch.empty(shape, device="meta"))
    got = {k: tuple(v.shape)
           for k, v in _named({"cache": cache}, seqs=True).items()}
    assert got == {k: v for k, v in shapes.items() if k.startswith("cache/")}


def test_maybe_drops_an_axis_that_does_not_divide():
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))     # vocab 256, d_model 64
    specs = rules.param_specs(cfg, HostMesh((3, 4)))
    assert specs["embed/tokens"] == ("model", None)  # 64 % 3: embed replicated
    specs = rules.param_specs(cfg, HostMesh((2, 3)))
    assert specs["embed/tokens"] == (None, "data")   # 256 % 3: vocab replicated
    assert rules._maybe(HostMesh((4, 2)), 6, ("data", "model")) is None
    assert rules._maybe(HostMesh((4, 2)), 16, ("data", "model")) == ("data", "model")


def test_compute_spec_keeps_vocab_and_experts_split():
    assert T.compute_spec("embed/tokens", ("model", "data")) == (None, "data")
    assert T.compute_spec("unembed", ("data", "model")) == ("data", None)
    assert T.compute_spec("layers/p0/moe/w_up", (None, "model", "data", None)) \
        == (None, None, "data", None)
    assert T.compute_spec("layers/p0/moe/shared/w_up", (None, "data", "model")) \
        == (None, "data", "model")
    assert T.compute_spec("layers/p0/attn/wq", (None, "data", "model", None)) \
        == (None, "data", "model", None)


def test_layout_hints_are_identities():
    x = torch.randn(2, 3)
    assert A.constrain(x, "batch", None) is x and A.pin_param("w", x) is x
    assert A.psum(x, "model") is x and A.enter(x, "model") is x


def test_adafactor_under_a_mesh_needs_the_specs():
    A.set_mesh(HostMesh((1, 2)))
    try:
        with pytest.raises(ValueError, match="set_param_specs"):
            O.adafactor().init({"w": torch.zeros(4, 4)})
    finally:
        A.set_mesh(None)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vp_world(ref):
    vp = ref["vp"]
    return _run("loss_grads_case", 8, sizes=(4, 2), arch="qwen3-0.6b",
                act="float32", params=vp["params"], batch=_ints(vp["batch"]))


def test_vocab_parallel_loss_and_grads_match_reference(ref, vp_world):
    vp = ref["vp"]
    losses = [o[0] for o in vp_world]
    assert len(set(losses)) == 1                      # every rank, one loss
    loss, grads = vp_world[0]
    np.testing.assert_allclose(loss, vp["loss_mesh"], rtol=2e-5)
    np.testing.assert_allclose(loss, vp["loss"], rtol=2e-5)
    assert sorted(grads) == sorted(vp["grads"])
    for k in grads:
        assert _maxnorm_rel(grads[k], vp["grads_mesh"][k]) < 2e-2, k
        assert _maxnorm_rel(grads[k], vp["grads"][k]) < 2e-2, k


def test_vocab_parallel_loss_with_tensor_parallelism(ref, vp_world):
    """The reference's mesh run with tensor parallelism on, against the
    port's world: the port gathers the heads and MLP whether or not the
    reference splits them, so its side is the one computation of the test
    above."""
    vp = ref["vp"]
    loss, grads = vp_world[0]
    np.testing.assert_allclose(loss, vp["loss_tp"], rtol=5e-4)
    np.testing.assert_allclose(loss, vp["loss"], rtol=5e-4)
    for k in grads:
        assert _maxnorm_rel(grads[k], vp["grads"][k]) < 2e-2, k


def test_vocab_parallel_bf16_matches_one_process(ref):
    """bf16 activations, the smoke config's own: the (4, 2) world against
    the port's one-process step on the same weights and batch."""
    vp = ref["vp"]
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    assert cfg.activation_dtype == "bfloat16"
    params = params_from_reference(vp["params"], cfg)
    want, want_g = R.loss_and_grads(cfg, params, _ints(vp["batch"]))
    out = _run("loss_grads_case", 8, sizes=(4, 2), arch="qwen3-0.6b",
               act="bfloat16", params=vp["params"], batch=_ints(vp["batch"]))
    loss, grads = out[0]
    np.testing.assert_allclose(loss, float(want), rtol=2e-5)
    for k, g in want_g.items():
        assert _maxnorm_rel(grads[k], g.numpy()) < 2e-2, k


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_worlds(ref):
    moe = ref["moe"]
    return {sizes: _run("moe_case", sizes[0] * sizes[1], sizes=sizes, arch=MOE,
                        act="float32", params=moe["params"],
                        batch=_ints(moe["batch"]), lr=1e-3)
            for sizes in ((1, 2), (2, 2))}


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)], ids=str)
def test_expert_parallel_forward_matches_reference(ref, moe_worlds, sizes):
    moe = ref["moe"]
    for r in moe_worlds[sizes]:
        np.testing.assert_allclose(r["logits"], moe[sizes]["logits"], **F32_BOUND)
        np.testing.assert_allclose(r["last"], moe[sizes]["logits"][:, -1],
                                   **F32_BOUND)
    cfg = smoke_config(R.get_arch(MOE)).with_(activation_dtype="float32")
    one = T.forward(cfg, params_from_reference(moe["params"], cfg),
                    torch.from_numpy(_ints(moe["batch"])["tokens"])).logits
    one = one.detach().numpy()
    np.testing.assert_allclose(one, moe[None]["logits"], **F32_BOUND)
    if sizes == (1, 2):      # data 1: the single-card branch's capacity
        np.testing.assert_allclose(moe_worlds[sizes][0]["logits"], one,
                                   **F32_BOUND)
    else:                    # data 2: each rank's capacity counts B*S / 2
        assert np.abs(moe[sizes]["logits"] - moe[None]["logits"]).max() > 1e-4
        assert np.abs(moe_worlds[sizes][0]["logits"] - one).max() > 1e-4


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)], ids=str)
def test_expert_parallel_train_step_matches_reference(ref, moe_worlds, sizes):
    want = ref["moe"][sizes]
    for r in moe_worlds[sizes]:
        (loss, gnorm), = r["step"]["metrics"]
        np.testing.assert_allclose(loss, want["loss"], rtol=1e-6)
        np.testing.assert_allclose(gnorm, want["grad_norm"], rtol=1e-5)
        for k, w in want["params"].items():
            np.testing.assert_allclose(r["step"]["params"][k], w, **F32_BOUND,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# Sharded optimizer steps
# ---------------------------------------------------------------------------

OPTIMIZERS = ("adamw", "adafactor", "sgd")


@pytest.fixture(scope="module")
def optim_world(ref):
    vp = ref["vp"]
    batches = [_ints(vp["batch"]), _ints({k: v[::-1].copy()
                                          for k, v in vp["batch"].items()})]
    out = _run("train_steps_case", 4, sizes=(2, 2), arch="qwen3-0.6b",
               act="float32", params=vp["params"], batches=batches,
               optimizers=OPTIMIZERS, lr=1e-3)
    return out[0], batches


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_sharded_optimizer_step_equals_one_process(ref, optim_world, name):
    got, batches = optim_world
    got = got[name]
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    params = params_from_reference(ref["vp"]["params"], cfg)
    step = R.make_train_step(cfg, optimizer=name, lr=1e-3)
    opt = step.init_opt(params)
    for b, (loss, gnorm) in zip(batches, got["metrics"]):
        params, opt, m = step(params, opt, b)
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-6)
        np.testing.assert_allclose(gnorm, float(m["grad_norm"]), rtol=1e-5)
    for k, w in params.items():
        np.testing.assert_allclose(got["params"][k], w.numpy(), **F32_BOUND,
                                   err_msg=k)
    want_state = _named({k: v for k, v in opt.items() if k != "t"})
    got_state = _named({k: v for k, v in got["opt"].items() if k != "t"})
    assert sorted(got_state) == sorted(want_state)
    for k, w in want_state.items():
        w = w.numpy()
        np.testing.assert_allclose(got_state[k], w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    assert int(got["opt"]["t"]) == int(opt["t"]) == 2


# ---------------------------------------------------------------------------
# Checkpoints and remesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_world(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    vp = ref["vp"]
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    CheckpointManager(tmp / "one").save(
        5, params_from_reference(vp["params"], cfg), blocking=True)
    out = _run("checkpoint_case", 4, sizes=(2, 2), arch="qwen3-0.6b",
               params=vp["params"], one_dir=str(tmp / "one"),
               ref_dir=str(ref["ckpt"]), out_dir=str(tmp / "world"))
    return out, tmp / "world"


def test_converted_weights_shard_and_gather_back(ckpt_world):
    assert all(o["roundtrip"] for o in ckpt_world[0])


def test_world_save_sends_each_slice_once(ckpt_world):
    """The collective save hands each rank's slices to mesh rank 0 once
    (``dist.gather``) and calls no other collective that moves data, so no
    rank puts a whole leaf together on its device."""
    for o in ckpt_world[0]:
        t = o["save_traffic"]
        assert t["gather_bytes"] == t["own"] > 0 and t["others"] == 0, t


def test_world_restores_one_process_and_reference_checkpoints(ckpt_world):
    for o in ckpt_world[0]:
        assert o["one"] == (5, True) and o["ref"] == (3, True)


def test_world_checkpoint_restores_in_one_process(ckpt_world):
    out, d = ckpt_world
    assert [o["latest"] for o in out] == [7] * 4
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    template = ({k: torch.empty(0) for k in T.schema(cfg)},
                {"m": {k: torch.empty(0) for k in T.schema(cfg)},
                 "v": {k: torch.empty(0) for k in T.schema(cfg)},
                 "t": torch.empty(0)})
    (params, opt), step = CheckpointManager(d).restore(template)
    assert step == 7 and int(opt["t"]) == 1
    for k, w in out[0]["saved"].items():
        np.testing.assert_array_equal(params[k].numpy(), w, err_msg=k)
        np.testing.assert_array_equal(opt["m"][k].numpy(), out[0]["m"][k])


def test_world_checkpoint_restores_in_the_reference(ckpt_world):
    """The layout the world writes is the reference's: its restore reads
    it bit for bit (one device, no mesh)."""
    import jax
    from repro.train.checkpoint import CheckpointManager as RefManager
    jax.config.update("jax_platform_name", "cpu")
    out, d = ckpt_world
    template = ({k: 0 for k in out[0]["saved"]}, None)
    (params, _), step = RefManager(d).restore(template, 7)
    assert step == 7
    for k, w in out[0]["saved"].items():
        np.testing.assert_array_equal(np.asarray(params[k]), w, err_msg=k)


def test_other_mesh_restores_world_checkpoint(ckpt_world):
    out, d = ckpt_world
    got = _run("restore_case", 2, sizes=(1, 2), arch="qwen3-0.6b",
               ckpt_dir=str(d), step=7)
    for r in got:
        for k, w in out[0]["saved"].items():
            np.testing.assert_array_equal(r[k], w, err_msg=k)


def test_remesh_shrinks_and_grows_bit_for_bit(ref):
    vp = ref["vp"]
    out = _run("remesh_case", 4, arch="qwen3-0.6b", params=vp["params"])
    assert [o["small"] for o in out] == [({"data": 2, "model": 1}, True)] * 2 \
        + [({"data": 2, "model": 1}, False)] * 2
    for o in out:
        assert o["big"] == {"data": 4, "model": 1}
        for k, w in vp["params"].items():
            np.testing.assert_array_equal(o["big_whole"][k], w, err_msg=k)
            if "small_whole" in o:
                np.testing.assert_array_equal(o["small_whole"][k], w, err_msg=k)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

LAUNCH_ARGV = ["--device", "cpu", "--smoke", "--steps", "2", "--seq", "16",
               "--global-batch", "4", "--model-parallel", "2", "--ckpt-every",
               "1"]
LAUNCH_LR = 3e-4          # the launcher's default
# Two AdamW runs whose gradients round apart move an element apart by at
# most 2 lr |m^|/sqrt(v^) a step, and |m^|/sqrt(v^) <= 1.0004 at steps 1-2
# with betas (0.9, 0.95) (Cauchy-Schwarz over the two steps' weights);
# weight decay adds 0.1 lr of the gap.
ADAMW_DRIFT = 2 * LAUNCH_LR * 1.001


def _launched(d, cfg):
    (params, _), step = CheckpointManager(d).restore(
        ({k: torch.empty(0) for k in T.schema(cfg)}, None))
    return params, step


def _within_drift(got, want, steps):
    for k, w in want.items():
        d = (got[k] - w).abs().max().item()
        assert d <= steps * ADAMW_DRIFT, (k, d)


def test_launcher_model_parallel_in_a_world(tmp_path):
    """``--model-parallel 2`` in a (2, 2) world against one process that
    trains on the rows both data ranks read (``SyntheticLM`` with their
    ``host_id``), put together in data order: the losses at rtol 2e-5 (the
    bf16 one-process bound above), the checkpoint within AdamW's drift."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import init_weights
    argv = LAUNCH_ARGV + ["--ckpt-dir", str(tmp_path)]
    out = _run("launcher_case", 4, argv=argv)
    losses = [[h["loss"] for h in hist] for hist in out]
    assert len(losses[0]) == 2 and all(x == losses[0] for x in losses)
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    params, step = _launched(tmp_path, cfg)
    assert step == 2
    for k, d in T.schema(cfg).items():
        assert tuple(params[k].shape) == d.shape, k
    one = init_weights(cfg, seed=0, device="cpu")
    train_step = R.make_train_step(cfg, optimizer="adamw", lr=LAUNCH_LR)
    opt = train_step.init_opt(one)
    for i in range(2):
        parts = [SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4,
                             seed=0, host_id=h, num_hosts=2).batch(i)
                 for h in range(2)]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        one, opt, m = train_step(one, opt, batch)
        np.testing.assert_allclose(losses[0][i], float(m["loss"]), rtol=2e-5)
    _within_drift(params, one, 2)
    # a second run resumes from the world's checkpoint
    out = _run("launcher_case", 4, argv=argv[:4] + ["3"] + argv[5:])
    assert [len(h) for h in out] == [1] * 4


def test_launcher_world_at_data_1_equals_one_process(tmp_path):
    """A (1, 2) world reads the rows one process reads: the same argv and
    seed in both, the losses at rtol 2e-5 and the checkpoints within
    AdamW's drift (on the CPU they come out equal)."""
    from repro_torch.launch import train as launch_train
    out = _run("launcher_case", 2,
               argv=LAUNCH_ARGV + ["--ckpt-dir", str(tmp_path / "world")])
    one = launch_train.main(LAUNCH_ARGV + ["--ckpt-dir", str(tmp_path / "one")])
    want = [h["loss"] for h in one]
    for hist in out:
        np.testing.assert_allclose([h["loss"] for h in hist], want, rtol=2e-5)
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    got, step = _launched(tmp_path / "world", cfg)
    one_params, one_step = _launched(tmp_path / "one", cfg)
    assert step == one_step == 2
    _within_drift(got, one_params, 2)


def test_launcher_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--smoke", "--steps", "2", "--seq", "16",
         "--global-batch", "4", "--model-parallel", "2", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, cwd=REPO,
        timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "backend gloo" in out.stderr and "done: loss" in out.stderr
    assert "'model': 2" in out.stderr and (tmp_path / "step_2").exists()


# ---------------------------------------------------------------------------
# Each rank's draw
# ---------------------------------------------------------------------------

def _block(x, spec, index, shape):
    """The block of ``x`` at mesh coordinates ``index`` ({axis: i}) under
    ``spec`` on a mesh of ``shape`` ({axis: size})."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n, i = 1, 0
        for a in axes:
            n, i = n * shape[a], i * shape[a] + index[a]
        k = x.shape[dim] // n
        x = x.narrow(dim, i * k, k)
    return x


@pytest.mark.parametrize("sizes,compute_dtype,serving",
                         [((2, 2), False, False), ((1, 2), True, True)],
                         ids=["f32-masters-2x2", "bf16-serving-1x2"])
def test_init_weights_mesh_slices_match_one_process_draw(sizes, compute_dtype,
                                                         serving):
    """``init_weights(mesh=, specs=)``: each rank's leaves are bit for bit
    its blocks of the one-process draw (the router and zero leaves f32)."""
    from repro_torch.launch.serve import init_weights
    cfg = smoke_config(R.get_arch(MOE))
    whole = init_weights(cfg, seed=3, device="cpu", compute_dtype=compute_dtype)
    out = _run("init_case", sizes[0] * sizes[1], sizes=sizes, arch=MOE,
               compute_dtype=compute_dtype, serving=serving, seed=3)
    shape = dict(zip(("data", "model"), sizes))
    assert sorted(o["index"] for o in out) == sorted(
        (d, m) for d in range(sizes[0]) for m in range(sizes[1]))
    split = 0
    for o in out:
        index = dict(zip(("data", "model"), o["index"]))
        for k, w in whole.items():
            want = _block(w, o["specs"][k], index, shape)
            if want.dtype == torch.bfloat16:
                want = want.contiguous().view(torch.int16)
            np.testing.assert_array_equal(o["w"][k], want.numpy(), err_msg=k)
            split += want.numel() < w.numel()
    assert split > 0


def test_loop_retries_and_rolls_back_on_every_rank(tmp_path):
    """A step failing on one rank is retried, and after the retries run
    out rolled back, by every rank together; the run ends bit for bit where
    the fault-free run ends."""
    out = _run("loop_faults_case", 2, sizes=(1, 2),
               ckpt_dirs=[str(tmp_path / "faulty"), str(tmp_path / "clean")])
    for r in out:
        f, c = r["faulty"], r["clean"]
        assert (f["retries"], f["rollbacks"]) == (3, 1)
        assert (c["retries"], c["rollbacks"]) == (0, 0)
        assert f["steps"] == c["steps"] == [1, 2, 3, 4]
        assert f["losses"] == c["losses"] == out[0]["clean"]["losses"]
        for k, w in c["params"].items():
            np.testing.assert_array_equal(f["params"][k], w, err_msg=k)
