"""The training slice (models' loss and train step, data/pipeline's token
streams, train/checkpoint, train/loop, launch/train) against the reference
on the smoke qwen3 config, with the reference's weights carried across by
``convert.params_from_reference``.

Tolerances: in f32 activations the loss at rel 1e-5, every gradient at
rtol 1e-4 with atol 1e-6 * max|g| of its leaf, params after 3 AdamW steps
at atol 1e-5 (f32 forward and backward in two frameworks: sums reassociate
at the 1e-7 level, and Adam's m / sqrt(v) passes that on at about lr x
rel. error); in bf16 activations the first step's loss at rel 1e-2 and a
gradient cosine >= 0.999 for every leaf with norm > 1e-6 (XLA rounds every
bf16 op, PyTorch some fused ones once).  Checkpoints and token batches are
held bit for bit.
"""

import logging
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke
from repro.data import pipeline as ref_data
from repro.models import registry as RR
from repro.models import transformer as RT
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch.configs.base import smoke_config
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.data.pipeline import MemmapTokens, SyntheticLM, write_token_file
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.optim import galore
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import LoopConfig, train

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)
torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals

REPO = Path(__file__).resolve().parents[1]
SEQ, BATCH = 16, 4


@pytest.fixture(scope="module")
def qwen():
    """(ref_cfg, cfg, ref_params, numpy params) in f32 activations."""
    ref_cfg = ref_smoke(RR.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    cfg = smoke_config(R.get_arch("qwen3-0.6b")).with_(activation_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    return ref_cfg, cfg, ref_params, {k: np.asarray(v) for k, v in ref_params.items()}


def _port(params, cfg):
    return params_from_reference(params, cfg)


def _batch(step=0, vocab=256, seq=SEQ, batch=BATCH):
    return SyntheticLM(vocab=vocab, seq_len=seq, global_batch=batch).batch(step)


def _port_grads(cfg, params, batch):
    """Loss and gradients by the port's autograd through the cast."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = T.loss_fn(cfg, T.cast_params_for_compute(cfg, leaves),
                     {k: torch.as_tensor(v).long() for k, v in batch.items()})
    names = sorted(leaves)
    gs = torch.autograd.grad(loss, [leaves[k] for k in names])
    return float(loss.detach()), dict(zip(names, gs))


def _ref_grads(ref_cfg, ref_params, batch):
    def loss(p):
        return RT.loss_fn(ref_cfg, RT.cast_params_for_compute(ref_cfg, p),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    val, grads = jax.value_and_grad(loss)(ref_params)
    return float(val), {k: np.asarray(g) for k, g in grads.items()}


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_cross_entropy_matches_reference(cap):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((2, 8, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    labels[0, :3] = -1                               # ignored positions
    want, want_g = jax.value_and_grad(
        lambda lg: RT.cross_entropy(lg, jnp.asarray(labels), cap))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = T.cross_entropy(lg, torch.from_numpy(labels), cap)
    (got_g,) = torch.autograd.grad(got, lg)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-8)


def test_loss_and_grads_match_reference_f32(qwen):
    ref_cfg, cfg, ref_params, params = qwen
    batch = _batch()
    want, want_g = _ref_grads(ref_cfg, ref_params, batch)
    got, got_g = _port_grads(cfg, _port(params, cfg), batch)
    assert got == pytest.approx(want, rel=1e-5)
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        w = want_g[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_loss_and_grads_match_reference_bf16():
    ref_cfg = ref_smoke(RR.get_arch("qwen3-0.6b"))
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    assert cfg.activation_dtype == "bfloat16"
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = _port({k: np.asarray(v) for k, v in ref_params.items()}, cfg)
    batch = _batch(1)
    want, want_g = _ref_grads(ref_cfg, ref_params, batch)
    got, got_g = _port_grads(cfg, params, batch)
    assert got == pytest.approx(want, rel=1e-2)
    checked = 0
    for k, g in got_g.items():
        a, b = g.double().numpy().ravel(), want_g[k].astype(np.float64).ravel()
        if np.linalg.norm(b) <= 1e-6:
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.999, (k, cos)
        checked += 1
    assert checked >= len(got_g) - 2


@pytest.fixture(scope="module")
def ref_steps(qwen):
    """Jitted reference train steps by (optimizer, micro_batches)."""
    ref_cfg = qwen[0]
    cache = {}

    def get(name="adamw", micro=1):
        if (name, micro) not in cache:
            maker = RR.make_train_step(ref_cfg, optimizer=name, micro_batches=micro)
            cache[(name, micro)] = (jax.jit(maker), maker.init_opt)
        return cache[(name, micro)]
    return get


def _ref_run(ref_steps, ref_params, name, micro, steps):
    step, init_opt = ref_steps(name, micro)
    p, s = ref_params, init_opt(ref_params)
    losses = []
    for i in range(steps):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in _batch(i).items()})
        losses.append(float(m["loss"]))
    return p, s, losses


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_reference(qwen, ref_steps, micro):
    """3 AdamW steps (and with micro_batches=2, the reference's split and
    mean): losses at rel 1e-5 and params at atol 1e-5."""
    ref_cfg, cfg, ref_params, params = qwen
    want_p, _, want_l = _ref_run(ref_steps, ref_params, "adamw", micro, 3)
    step = R.make_train_step(cfg, micro_batches=micro)
    p = _port(params, cfg)
    s = step.init_opt(p)
    for i in range(3):
        p, s, m = step(p, s, _batch(i))
        assert float(m["loss"]) == pytest.approx(want_l[i], rel=1e-5)
        assert float(m["grad_norm"]) > 0
    for k, v in p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]), atol=1e-5,
                                   err_msg=k)


def test_micro_batches_average_the_full_batch(qwen):
    """micro_batches=2 gives the full batch's loss and (in f32) its update."""
    _, cfg, _, params = qwen
    p = _port(params, cfg)
    outs = []
    for micro in (1, 2):
        step = R.make_train_step(cfg, optimizer="sgd", lr=1.0, micro_batches=micro)
        outs.append(step(p, step.init_opt(p), _batch()))
    assert float(outs[1][2]["loss"]) == pytest.approx(float(outs[0][2]["loss"]),
                                                      rel=1e-6)
    for k in p:
        np.testing.assert_allclose(outs[1][0][k].numpy(), outs[0][0][k].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_reference_run_continues_in_port(qwen, ref_steps, name):
    """2 reference steps, params and optimizer state carried across
    (params_from_reference, opt_state_from_reference), 1 port step: the
    reference's 3-step params at atol 1e-5."""
    ref_cfg, cfg, ref_params, _ = qwen
    p2, s2, _ = _ref_run(ref_steps, ref_params, name, 1, 2)
    p3, _, _ = _ref_run(ref_steps, ref_params, name, 1, 3)
    step = R.make_train_step(cfg, optimizer=name)
    p = _port({k: np.asarray(v) for k, v in p2.items()}, cfg)
    p, s, _ = step(p, opt_state_from_reference(s2), _batch(2))
    assert int(s["t"]) == 3
    for k, v in p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(p3[k]), atol=1e-5,
                                   err_msg=k)


def test_train_step_refuses_flash_kernel(qwen):
    with pytest.raises(ValueError, match="no backward"):
        R.make_train_step(qwen[1].with_(use_flash_kernel=True))


def test_train_step_leaves_inputs_unchanged(qwen):
    """The step is functional: the loop retries from the state it holds."""
    _, cfg, _, params = qwen
    step = R.make_train_step(cfg, optimizer=galore.galore(1e-3, rank=8,
                                                          refresh_every=2))
    p = _port(params, cfg)
    s = step.init_opt(p)
    before = {k: v.clone() for k, v in p.items()}
    p2, s2, m = step(p, s, _batch())
    assert all(torch.equal(before[k], p[k]) for k in p)
    assert not any(torch.equal(p2[k], p[k]) for k in p if k.endswith("/wq"))
    assert s2["leaves"]["embed/tokens"].proj.abs().sum() > 0
    assert s["leaves"]["embed/tokens"].proj.abs().sum() == 0
    assert not any(v.requires_grad for v in p2.values())


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _flat(tree):
    from repro_torch.train.checkpoint import _flatten
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _flatten(tree).items()}


def _assert_bitwise(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoints_cross_packages(qwen, ref_steps, tmp_path):
    """A reference checkpoint (params + AdamW state after a step) restores
    in the port, and the port's restores in the reference, bit for bit."""
    ref_cfg, cfg, ref_params, _ = qwen
    p1, s1, _ = _ref_run(ref_steps, ref_params, "adamw", 1, 1)
    ref_mgr = RefCheckpointManager(tmp_path / "ref")
    ref_mgr.save(1, (p1, s1), blocking=True)
    ref_mgr.close()
    tmpl_p = T.init_params(cfg, torch.Generator().manual_seed(3))
    tmpl = (tmpl_p, R.make_train_step(cfg).init_opt(tmpl_p))
    (got_p, got_s), step = CheckpointManager(tmp_path / "ref").restore(tmpl)
    assert step == 1
    _assert_bitwise((got_p, got_s), (p1, s1))
    assert got_s["t"].dtype == torch.int32

    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(7, (got_p, got_s), blocking=True)
    mgr.close()
    (rp, rs), rstep = RefCheckpointManager(tmp_path / "port").restore((ref_params, s1))
    assert rstep == 7
    _assert_bitwise((rp, rs), (p1, s1))


def test_galore_checkpoint_round_trip(qwen, tmp_path):
    """GaLore's state (named-tuple leaves, None bases, uint32 key words)
    restores bit for bit, each leaf on its template's device with its saved
    strides (the column-major basis stays column-major).  The reference's
    restore cannot rebuild a named tuple: it calls ``_Leaf(<generator>)``."""
    _, cfg, _, params = qwen
    step = R.make_train_step(cfg, optimizer=galore.galore(1e-3, rank=8,
                                                          refresh_every=2))
    p = _port(params, cfg)
    p, s, _ = step(p, step.init_opt(p), _batch())
    s["leaves"]["embed/tokens"] = s["leaves"]["embed/tokens"]._replace(
        proj=s["leaves"]["embed/tokens"].proj.T.contiguous().T)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, (p, s), blocking=True)
    tmpl = (p, step.init_opt(p))
    (rp, rs), _ = mgr.restore(tmpl)
    _assert_bitwise((rp, rs), (p, s))
    assert isinstance(rs["leaves"]["embed/tokens"], galore._Leaf)
    assert rs["leaves"]["b" if "b" in rs["leaves"] else "final_norm/scale"].proj is None
    assert rs["key"].dtype == torch.uint32
    assert (rs["leaves"]["embed/tokens"].proj.stride()
            == s["leaves"]["embed/tokens"].proj.stride())
    from repro.optim.galore import _Leaf as RefLeaf
    with pytest.raises(TypeError):
        RefCheckpointManager(tmp_path).restore(
            {"leaves": {"embed/tokens": RefLeaf(None, np.zeros(1), np.zeros(1))}})
    mgr.close()


def test_checkpoint_roundtrip_keep_and_atomic(tmp_path):
    """The reference's test_checkpoint_roundtrip and
    test_checkpoint_atomic_no_partial."""
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.int32)},
            "tup": (torch.zeros((2, 2)),)}
    for s in (10, 20, 30):
        mgr.save(s, {"a": tree["a"] + s, "nested": {"b": tree["nested"]["b"] + s},
                     "tup": (tree["tup"][0] + s,)})
    mgr.wait()
    assert mgr.latest_step() == 30
    assert not (tmp_path / "step_10").exists()
    restored, step = mgr.restore(tree)
    assert step == 30
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(12.0).reshape(3, 4) + 30)
    assert isinstance(restored["tup"], tuple)
    (tmp_path / "step_40.tmp").mkdir()
    assert mgr.latest_step() == 30
    mgr.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(tree)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_synthetic_batches_equal_reference():
    kw = dict(vocab=100, seq_len=16, global_batch=8, seed=7, num_hosts=2)
    for host in (0, 1):
        got = SyntheticLM(host_id=host, **kw)
        want = ref_data.SyntheticLM(host_id=host, **kw)
        for step in (0, 3, 42):
            b, w = got.batch(step), want.batch(step)
            for k in ("tokens", "labels"):
                assert b[k].dtype == np.int32
                np.testing.assert_array_equal(b[k], w[k])
    b = SyntheticLM(**kw).batch(3)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert not np.array_equal(SyntheticLM(host_id=0, **kw).batch(5)["tokens"],
                              SyntheticLM(host_id=1, **kw).batch(5)["tokens"])
    with pytest.raises(ValueError, match="split"):
        SyntheticLM(vocab=10, seq_len=4, global_batch=3, num_hosts=2).host_batch


def test_memmap_batches_equal_reference(tmp_path):
    toks = np.arange(10_000) % 257
    write_token_file(tmp_path / "port.bin", toks)
    ref_data.write_token_file(tmp_path / "ref.bin", toks)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    got = MemmapTokens(tmp_path / "port.bin", seq_len=32, global_batch=4, seed=3)
    want = ref_data.MemmapTokens(tmp_path / "ref.bin", seq_len=32, global_batch=4,
                                 seed=3)
    for step in (0, 9):
        b, w = got.batch(step), want.batch(step)
        assert b["tokens"].shape == (4, 32)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], w[k])
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# The loop (the reference's test_train_loop_* and the port's counters)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    step = R.make_train_step(cfg, lr=1e-3)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    return params, step, step.init_opt(params), data


def _run(tiny, tmp, total, step_fn=None, **kw):
    params, step, opt, data = tiny
    lcfg = LoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(tmp), **kw)
    return train(step_fn or step, params, opt, data, lcfg, return_state=True)


def test_train_loop_runs_and_checkpoints(tiny, tmp_path):
    p, o, hist, st = _run(tiny, tmp_path, 6)
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5, 6]
    assert sorted(q.name for q in tmp_path.iterdir()) == ["step_2", "step_4",
                                                         "step_6"]
    assert st.retries == st.rollbacks == 0 and st.resumed_from is None
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_loop_resumes_bitwise(tiny, tmp_path):
    """4 steps, then a run to 6 resumes at 4 and equals the uninterrupted
    6-step run bit for bit."""
    clean_p, clean_o, clean_hist, _ = _run(tiny, tmp_path / "clean", 6)
    _run(tiny, tmp_path / "run", 4)
    p, o, hist, st = _run(tiny, tmp_path / "run", 6)
    assert st.resumed_from == 4 and [h["step"] for h in hist] == [5, 6]
    assert [h["loss"] for h in hist] == [h["loss"] for h in clean_hist[4:]]
    _assert_bitwise((p, o), (clean_p, clean_o))


def test_train_loop_retries_transient_failure(tiny, tmp_path, caplog):
    clean_p, _, _, _ = _run(tiny, tmp_path / "clean", 5)
    calls = {"n": 0}

    def flaky(p, o, b):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated preemption")
        return tiny[1](p, o, b)

    with caplog.at_level(logging.WARNING):
        p, _, hist, st = _run(tiny, tmp_path / "flaky", 5, step_fn=flaky)
    assert len(hist) == 5 and st.retries == 1 and st.rollbacks == 0
    assert any("failed" in r.message for r in caplog.records)
    _assert_bitwise(p, clean_p)


def test_train_loop_rolls_back(tiny, tmp_path):
    """A step failing max_retries + 1 times restores the last checkpoint and
    the steps after it run again: the params equal the clean run's."""
    clean_p, _, _, _ = _run(tiny, tmp_path / "clean", 5)
    calls = {"n": 0}

    def failing_at_step_4(p, o, b):
        calls["n"] += 1
        if 4 <= calls["n"] <= 6:          # step 4's three attempts
            raise RuntimeError("simulated hardware fault")
        return tiny[1](p, o, b)

    p, _, hist, st = _run(tiny, tmp_path / "rb", 5, step_fn=failing_at_step_4)
    assert st.rollbacks == 1 and st.retries == 2
    assert [h["step"] for h in hist] == [1, 2, 3, 3, 4, 5]
    _assert_bitwise(p, clean_p)

    def always(p, o, b):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError, match="dead"):
        _run(tiny, tmp_path / "dead", 5, step_fn=always)


def test_train_loop_emergency_save_on_sigterm(tiny, tmp_path):
    params, step, opt, data = tiny
    lcfg = LoopConfig(total_steps=10, ckpt_every=100, ckpt_dir=str(tmp_path))

    def hook(i, p, row):
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    _, _, hist, st = train(step, params, opt, data, lcfg, hooks=[hook],
                           return_state=True)
    assert st.interrupted and len(hist) == 3 and (tmp_path / "step_3").exists()
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "4", "--seq", "16", "--global-batch", "4",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: loss" in out.stderr and (tmp_path / "step_4").exists()


def test_launcher_keeps_reference_flags():
    ref = subprocess.run([sys.executable, "-m", "repro.launch.train", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert ref.returncode == 0, ref.stderr[-2000:]
    for flag in ("--optimizer", "--micro-batches", "--model-parallel", "--data",
                 "--ckpt-every", "--global-batch"):
        assert flag in ref.stdout
    args = launch_train.parse_args(["--optimizer", "adafactor"])
    assert args.optimizer == "adafactor" and args.device is None
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--optimizer", "galore"])
