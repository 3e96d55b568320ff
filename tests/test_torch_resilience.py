"""stream/resilience.py and the checkpoint paths of the streamed drivers
against the reference, on the same numpy inputs.

Bit for bit against the reference: key fingerprints, ``partition_rows``,
the fault schedules of ``FaultySource`` and ``FlakyRangeFetcher`` for the
same seeds, and the checkpoint manifests of the same kernel-2 job (all but
their wall-clock ``time``).  Bit for bit within the port: payload round
trips, the Omega an Omega-carrying state draws again on restore,
checkpointed runs against plain ones for every method, resumes after a
fault in the sketch, B, power and Tucker passes and after SIGKILL, elastic
host loss against the full fleet.  Against the reference at the streamed
tolerance (reconstruction error rtol 1e-3, as ``test_torch_streamed.py``):
a resumed port run, and a reference ``shgemm_fused`` checkpoint finished in
the port.  The reference side stays at <= 128 rows (its kernel 2 runs in
Pallas interpret mode)."""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stream as rstream
from repro.core import projection as ref_proj
from repro.core import rsvd as ref_rsvd
from repro.stream import resilience as ref_resil
from repro_torch import main_path, stream
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.core import hosvd, projection as proj, rsvd
from repro_torch.data import pipeline
from repro_torch.stream import resilience as resil

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

SEED = 42
KEY = key_from_seed(SEED)
JKEY = jax.random.PRNGKey(SEED)
ALL_METHODS = ["f32", "lowp_single", "shgemm", "shgemm3", "shgemm_pallas",
               "shgemm_fused"]
M, N, RANK = 96, 80, 8
TILE = 16                       # 6 tiles a pass
EVERY = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def matrix():
    return np.random.default_rng(1).standard_normal((M, N)).astype(np.float32)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory, matrix):
    d = tmp_path_factory.mktemp("resil_shards")
    pipeline.write_matrix_shards(d, matrix, 32)   # 3 shards + manifest.json
    return d


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's non-fused Omega := the reference's jax.random Omega for the
    same key words (a documented deviation), also when a restored state
    draws it again."""
    def materialize(key, shape, *, dist="gaussian", s=None,
                    dtype=torch.bfloat16, device=None):
        jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
               torch.float32: jnp.float32}[dtype]
        omega = ref_proj.materialize_omega(jnp.asarray(np.array(key, np.uint32)),
                                           shape, dist=dist, s=s, dtype=jdt)
        return from_reference(np.asarray(omega)).to(device)
    monkeypatch.setattr(proj, "materialize_omega", materialize)


def _src(matrix):
    return stream.ArraySource(matrix, TILE)


def _job(method="shgemm_fused", passes=2):
    def run(src, **kw):
        return rsvd.rsvd_streamed(KEY, src, RANK, method=method, passes=passes,
                                  device="cpu", **kw)
    return run


def _err(a, res):
    return float(rsvd.reconstruction_error(torch.from_numpy(a), res))


def _ref_err(a, res):
    return float(ref_rsvd.reconstruction_error(jnp.asarray(a), res))


class _SyncWriter:
    """The reference's AsyncWriter run inline: its checkpoint is on disk when
    its driver raises (the reference leaves the write in flight)."""

    def __init__(self, name=None):
        pass

    def submit(self, fn):
        fn()

    def wait(self):
        pass

    close = wait


# ---------------------------------------------------------------------------
# Bit for bit against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_key_fingerprint_matches_reference(seed):
    assert (resil.key_fingerprint(key_from_seed(seed))
            == ref_resil.key_fingerprint(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("r0,r1,parts,tile_rows", [
    (100, 196, 3, 16), (0, 96, 4, 16), (0, 10, 4, 16), (0, 0, 4, None),
    (5, 1029, 3, 256), (0, 17, 5, None), (32, 32 + 1024, 7, 128)])
def test_partition_rows_matches_reference(r0, r1, parts, tile_rows):
    got = resil.partition_rows(r0, r1, parts, tile_rows=tile_rows)
    assert got == ref_resil.partition_rows(r0, r1, parts, tile_rows=tile_rows)
    if got:
        assert got[0][0] == r0 and got[-1][1] == r1
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(got, got[1:]))


def test_partition_rows_errors_match_reference():
    for args, match in (((0, 10, 0), "parts"), ((10, 0, 2), "negative")):
        for fn in (resil.partition_rows, ref_resil.partition_rows):
            with pytest.raises(ValueError, match=match):
                fn(*args)


@pytest.mark.parametrize("seed", [0, 7, 123, 2024])
def test_faulty_source_seed_schedule_matches_reference(matrix, shard_dir, seed):
    """Same seed, same fault tile, for an array and a directory source."""
    pairs = ((stream.ArraySource(matrix, TILE), rstream.ArraySource(matrix, TILE)),
             (stream.DirectorySource(shard_dir, 24),
              rstream.DirectorySource(shard_dir, 24)))
    for ours, theirs in pairs:
        got = resil.FaultySource(ours, seed=seed).fail_at_tile
        assert got == ref_resil.FaultySource(theirs, seed=seed).fail_at_tile
        assert resil._count_tiles(ours) == ref_resil._count_tiles(theirs)


@pytest.mark.parametrize("rate,seed,n_faults", [(0.5, 3, 2), (0.2, 11, None),
                                                (0.05, 0, None)])
def test_flaky_fetcher_schedule_matches_reference(shard_dir, rate, seed, n_faults):
    from repro.stream.objectstore import FileRangeFetcher as RefFetcher
    url = str(sorted(shard_dir.glob("*.npy"))[0])
    outcomes = []
    for fetcher in (resil.FlakyRangeFetcher(stream.FileRangeFetcher(), rate=rate,
                                            seed=seed, n_faults=n_faults),
                    ref_resil.FlakyRangeFetcher(RefFetcher(), rate=rate,
                                                seed=seed, n_faults=n_faults)):
        seen = []
        for _ in range(40):
            try:
                seen.append(fetcher.read(url, 0, 16))
            except TimeoutError:
                seen.append("fault")
        outcomes.append((seen, fetcher.injected, fetcher.reads))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] > 0


def test_checkpoint_manifests_match_reference(matrix, tmp_path):
    """The same kernel-2 job writes the same checkpoints: format, phase,
    pass, cursor, fingerprint, state meta and array layout (all but the
    wall-clock time)."""
    ref_rsvd.rsvd_streamed(JKEY, rstream.ArraySource(matrix, TILE), RANK,
                           checkpoint_dir=tmp_path / "ref",
                           checkpoint_every_tiles=EVERY)
    _job()(_src(matrix), checkpoint_dir=tmp_path / "port",
           checkpoint_every_tiles=EVERY)
    names = [sorted(p.name for p in (tmp_path / side).glob("ckpt_*"))
             for side in ("ref", "port")]
    assert names[0] == names[1] and len(names[0]) == 2
    for name in names[0]:
        docs = [json.loads((tmp_path / side / name / "manifest.json").read_text())
                for side in ("ref", "port")]
        for doc in docs:
            doc.pop("time")
        assert docs[1] == docs[0], name
    for name in ("resilience.json", "heartbeat.json"):
        keys = [set(json.loads((tmp_path / side / name).read_text()))
                for side in ("ref", "port")]
        assert keys[0] == keys[1]


# ---------------------------------------------------------------------------
# Payloads: bit for bit within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,left", [("shgemm_fused", False),
                                         ("shgemm_fused", True),
                                         ("shgemm", False), ("shgemm", True),
                                         ("f32", False)])
def test_state_payload_roundtrip_bitwise(method, left):
    st = stream.init(KEY, N, 12, max_rows=M, left=left, method=method,
                     device="cpu")
    stream.update(st, torch.ones((TILE, N)), 0)
    arrays, meta = resil.state_to_payload(st)
    meta = json.loads(json.dumps(resil._jsonable(meta)))  # as the manifest does
    assert arrays["state.key_omega"].dtype == np.uint32
    assert arrays["state.rows_seen"].dtype == np.int32 and arrays["state.rows_seen"].ndim == 0
    assert not any(k.endswith("omega") and k != "state.key_omega" for k in arrays)
    back = resil.state_from_payload(arrays, meta, device="cpu")
    assert torch.equal(back.y, st.y) and back.key_omega == st.key_omega
    assert back.rows_seen == st.rows_seen == TILE
    assert (back.w is None) == (st.w is None)
    if left:
        assert torch.equal(back.w, st.w) and back.key_psi == st.key_psi
    for f in ("n_cols", "p", "l", "method", "dist", "omega_dtype", "col_base"):
        assert getattr(back, f) == getattr(st, f), f
    blk = torch.full((TILE, N), 0.5)
    stream.update(st, blk, TILE)
    stream.update(back, blk, TILE)
    assert torch.equal(back.y, st.y)
    if left:
        assert torch.equal(back.w, st.w)


@pytest.mark.parametrize("dist", ["gaussian", "achlioptas", "very_sparse"])
@pytest.mark.parametrize("omega_dtype", [torch.bfloat16, torch.float16], ids=str)
def test_restored_state_draws_the_saved_states_omega(dist, omega_dtype):
    """The payload holds no Omega: a restored Omega-carrying state draws it
    again from its key words, bit for bit the saved state's."""
    st = stream.init(KEY, N, 12, max_rows=M, method="shgemm", dist=dist,
                     omega_dtype=omega_dtype, device="cpu")
    back = resil.state_from_payload(*resil.state_to_payload(st), device="cpu")
    assert back.omega.dtype == omega_dtype
    assert torch.equal(back.omega.view(torch.int16), st.omega.view(torch.int16))


@pytest.mark.parametrize("method,dist", [("shgemm_fused", "gaussian"),
                                         ("shgemm", "gaussian"),
                                         ("shgemm_fused", "khatri_rao")])
def test_tucker_payload_roundtrip_bitwise(method, dist):
    dims = (32, 10, 8)
    ts = stream.tucker_init(KEY, dims, (5, 4, 3), method=method, dist=dist,
                            device="cpu")
    stream.tucker_update(ts, torch.ones((8,) + dims[1:]), 0)
    arrays, meta = resil.tucker_to_payload(ts)
    meta = json.loads(json.dumps(resil._jsonable(meta)))
    back = resil.tucker_from_payload(arrays, meta, device="cpu")
    assert torch.equal(back.z, ts.z) and back.key_psis == ts.key_psis
    assert (back.dims, back.ranks, back.core_dims) == (ts.dims, ts.ranks, ts.core_dims)
    slab = torch.full((8,) + dims[1:], 0.25)
    stream.tucker_update(ts, slab, 8)
    stream.tucker_update(back, slab, 8)
    assert torch.equal(back.z, ts.z)
    for m1, m2 in zip(ts.modes, back.modes):
        assert torch.equal(m1.y, m2.y)
        assert (m1.omega is None) == (m2.omega is None)


def test_commit_is_not_torn_by_later_updates(tmp_path, monkeypatch):
    """commit copies the arrays on the driver's thread: the port updates its
    states in place (on the CPU ``.numpy()`` shares their memory), so a slow
    writer would otherwise save a later tile's state."""
    real = resil.atomic_write_dir

    def slow(*args, **kw):
        time.sleep(0.3)
        return real(*args, **kw)
    monkeypatch.setattr(resil, "atomic_write_dir", slow)
    st = stream.init(KEY, N, 12, max_rows=M, left=True, method="shgemm_fused",
                     device="cpu")
    stream.update(st, torch.ones((TILE, N)), 0)
    want = (st.y.clone(), st.w.clone())
    ck = resil.SketchJobCheckpointer(tmp_path, every_tiles=1)
    b = torch.ones((3, N))
    ck.commit(phase="b", pass_idx=2, tiles_done=1, rows_done=TILE,
              payload=lambda: ({**resil.state_to_payload(st)[0], "b": b},
                               resil.state_to_payload(st)[1]))
    stream.update(st, torch.full((TILE, N), 3.0), TILE)
    st.y += 1.0
    b += 1.0
    ck.wait()
    saved = sorted(tmp_path.glob("ckpt_*"))[-1]
    assert np.array_equal(np.load(saved / "state.y.npy"), want[0].numpy())
    assert np.array_equal(np.load(saved / "state.w.npy"), want[1].numpy())
    assert np.array_equal(np.load(saved / "b.npy"), np.ones((3, N), np.float32))


def test_raising_driver_leaves_its_newest_checkpoint_on_disk(matrix, tmp_path,
                                                             monkeypatch):
    """With a slow disk, the fault reaches the caller only after the
    pending writes: the newest checkpoint on disk is the last one cut."""
    real = resil.atomic_write_dir

    def slow(*args, **kw):
        time.sleep(0.2)
        return real(*args, **kw)
    monkeypatch.setattr(resil, "atomic_write_dir", slow)
    faulty = resil.FaultySource(_src(matrix), fail_at_tile=5)
    with pytest.raises(resil.FaultInjected):
        _job()(faulty, checkpoint_dir=tmp_path, checkpoint_every_tiles=EVERY)
    newest = sorted(tmp_path.glob("ckpt_*"))[-1]
    man = json.loads((newest / "manifest.json").read_text())
    assert (man["phase"], man["tiles_done"], man["rows_done"]) == ("sketch", 4, 64)
    assert all((newest / f"{k}.npy").is_file() for k in man["arrays"])


# ---------------------------------------------------------------------------
# Checkpointed drivers: bit for bit against the uninterrupted run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ALL_METHODS)
def test_checkpointed_run_bitwise_all_methods(matrix, tmp_path, method):
    for passes in (1, 2, 3):
        run = _job(method, passes)
        base = run(_src(matrix))
        res, rep = run(_src(matrix), checkpoint_dir=tmp_path / str(passes),
                       checkpoint_every_tiles=EVERY, return_report=True)
        assert _same(base, res), passes
        assert rep.attempts == 1 and rep.goodput == 1.0
        assert rep.tiles_recomputed == 0 and rep.tiles_total == 6 * passes


@pytest.mark.parametrize("passes", [1, 2, 3, 4])
def test_resume_after_fault_bitwise(matrix, tmp_path, passes):
    """A fault in the sketch pass; the resume reproduces the uninterrupted
    factors bit for bit with <= every_tiles tiles replayed."""
    run = _job(passes=passes)
    base = run(_src(matrix))
    res, rep = main_path.resume_after_fault(
        run, _src(matrix), fail_at_tile=5, checkpoint_dir=tmp_path,
        checkpoint_every_tiles=EVERY)
    assert _same(base, res)
    assert rep.attempts == 2 and rep.tiles_recomputed <= EVERY
    assert len(rep.recovery_events) == 1 and 0.0 < rep.goodput <= 1.0


def test_resume_during_b_pass_bitwise(matrix, tmp_path):
    """A fault in the B pass: the newest checkpoint (on disk when the driver
    raises) is a B checkpoint with the partial B, and the resume starts
    inside the B pass."""
    run = _job()
    base = run(_src(matrix))
    faulty = resil.FaultySource(_src(matrix), fail_at_tile=6 + 3)
    with pytest.raises(resil.FaultInjected):
        run(faulty, checkpoint_dir=tmp_path, checkpoint_every_tiles=EVERY,
            resume=True)
    man = json.loads((sorted(tmp_path.glob("ckpt_*"))[-1] /
                      "manifest.json").read_text())
    assert man["phase"] == "b" and "b" in man["arrays"]
    assert (man["tiles_done"], man["rows_done"]) == (2, 32)
    res, rep = run(_src(matrix), checkpoint_dir=tmp_path,
                   checkpoint_every_tiles=EVERY, resume=True, return_report=True)
    assert _same(base, res)
    assert rep.tiles_recomputed == 1 and rep.recovery_events[0]["phase"] == "b"


@pytest.mark.parametrize("method", ["shgemm_fused", "shgemm"])
def test_resume_during_power_pass_bitwise(matrix, tmp_path, method):
    """passes >= 3 checkpoint at pass boundaries: a fault in pass 3 resumes
    from the pass-2 basis."""
    run = _job(method, 4)
    base = run(_src(matrix))
    res, rep = main_path.resume_after_fault(
        run, _src(matrix), fail_at_tile=2 * 6 + 3, checkpoint_dir=tmp_path,
        checkpoint_every_tiles=EVERY)
    assert _same(base, res) and rep.attempts == 2


@pytest.mark.parametrize("dist", ["gaussian", "khatri_rao"])
def test_checkpointed_tucker_bitwise(tmp_path, dist):
    t = np.random.default_rng(5).standard_normal((64, 12, 10)).astype(np.float32)

    def run(src, **kw):
        return hosvd.rp_sthosvd_streamed(KEY, src, ranks=(6, 5, 4), dist=dist,
                                         device="cpu", **kw)
    base = run(stream.ArraySource(t, 16))
    res, rep = run(stream.ArraySource(t, 16), checkpoint_dir=tmp_path / "a",
                   checkpoint_every_tiles=1, return_report=True)
    assert torch.equal(base.core, res.core) and _same(base.factors, res.factors)
    assert rep.goodput == 1.0
    res2, rep2 = main_path.resume_after_fault(
        run, stream.ArraySource(t, 16), fail_at_tile=2,
        checkpoint_dir=tmp_path / "b", checkpoint_every_tiles=1)
    assert torch.equal(base.core, res2.core) and _same(base.factors, res2.factors)
    assert rep2.attempts == 2 and rep2.tiles_recomputed <= 1


def test_no_resume_wipes_previous_job(matrix, tmp_path):
    faulty = resil.FaultySource(_src(matrix), fail_at_tile=4)
    with pytest.raises(resil.FaultInjected):
        _job()(faulty, checkpoint_dir=tmp_path, checkpoint_every_tiles=EVERY,
               resume=True)
    assert list(tmp_path.glob("ckpt_*"))
    res, rep = _job()(_src(matrix), checkpoint_dir=tmp_path,
                      checkpoint_every_tiles=EVERY, resume=False,
                      return_report=True)
    assert rep.attempts == 1 and not rep.recovery_events
    assert _same(res, _job()(_src(matrix)))


def test_fingerprint_mismatch_fails_loudly(matrix, tmp_path):
    faulty = resil.FaultySource(_src(matrix), fail_at_tile=4)
    with pytest.raises(resil.FaultInjected):
        _job()(faulty, checkpoint_dir=tmp_path, checkpoint_every_tiles=EVERY,
               resume=True)
    for kw, field in ((dict(key=key_from_seed(999)), "key"),
                      (dict(rank=RANK + 1), "p_hat"),
                      (dict(method="shgemm"), "omega")):
        args = dict(key=KEY, rank=RANK, method="shgemm_fused") | kw
        with pytest.raises(RuntimeError, match=f"fingerprint mismatch.*{field}"):
            rsvd.rsvd_streamed(args["key"], _src(matrix), args["rank"],
                               method=args["method"], checkpoint_dir=tmp_path,
                               checkpoint_every_tiles=EVERY, resume=True,
                               device="cpu")


def test_checkpoint_arg_validation_matches_reference(matrix, tmp_path):
    jsrc = rstream.ArraySource(matrix, TILE)
    for kw, match in ((dict(resume=True), "checkpoint_dir"),
                      (dict(checkpoint_every_tiles=2), "checkpoint_dir"),
                      (dict(return_report=True), "checkpoint_dir"),
                      (dict(tol=1e-2, checkpoint_dir=tmp_path), "adaptive"),
                      (dict(checkpoint_dir=tmp_path, checkpoint_every_tiles=0),
                       "checkpoint_every_tiles must be >= 1")):
        with pytest.raises(ValueError, match=match):
            ref_rsvd.rsvd_streamed(JKEY, jsrc, RANK, **kw)
        with pytest.raises(ValueError, match=match):
            _job()(_src(matrix), **kw)
    gen = lambda: (matrix[i:i + TILE] for i in range(0, M, TILE))  # noqa: E731
    with pytest.raises(ValueError, match="replayable"):
        rsvd.rsvd_streamed(KEY, gen(), RANK, n_rows=M, n_cols=N, passes=1,
                           checkpoint_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="replayable slab source"):
        hosvd.rp_sthosvd_streamed(KEY, iter([matrix.reshape(M, 8, 10)]),
                                  dims=(M, 8, 10), ranks=(2, 2, 2),
                                  checkpoint_dir=tmp_path, device="cpu")


# ---------------------------------------------------------------------------
# Against the reference at the streamed tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["shgemm_fused", "shgemm"])
def test_resumed_port_run_matches_reference(reference_draws, matrix, tmp_path,
                                            method):
    want = ref_rsvd.rsvd_streamed(JKEY, rstream.ArraySource(matrix, TILE), RANK,
                                  method=method)
    got, rep = main_path.resume_after_fault(
        _job(method), _src(matrix), fail_at_tile=6 + 4, checkpoint_dir=tmp_path,
        checkpoint_every_tiles=EVERY)
    assert rep.attempts == 2
    np.testing.assert_allclose(_err(matrix, got), _ref_err(matrix, want), rtol=1e-3)


def test_reference_fused_checkpoint_finishes_in_port(matrix, tmp_path,
                                                     monkeypatch):
    """The reference's shgemm_fused checkpoint (its fingerprint is the
    port's) restores in the port, which finishes the job."""
    monkeypatch.setattr(ref_resil, "AsyncWriter", _SyncWriter)
    want = ref_rsvd.rsvd_streamed(JKEY, rstream.ArraySource(matrix, TILE), RANK)
    faulty = ref_resil.FaultySource(rstream.ArraySource(matrix, TILE),
                                    fail_at_tile=5)
    with pytest.raises(ref_resil.FaultInjected):
        ref_rsvd.rsvd_streamed(JKEY, faulty, RANK, checkpoint_dir=tmp_path,
                               checkpoint_every_tiles=EVERY, resume=True)
    got, rep = _job()(_src(matrix), checkpoint_dir=tmp_path,
                      checkpoint_every_tiles=EVERY, resume=True,
                      return_report=True)
    assert rep.attempts == 2 and rep.tiles_recomputed <= EVERY
    np.testing.assert_allclose(_err(matrix, got), _ref_err(matrix, want), rtol=1e-3)


@pytest.mark.parametrize("method", ["shgemm", "f32", "shgemm_pallas"])
def test_reference_checkpoint_of_other_method_refused(matrix, tmp_path,
                                                      monkeypatch, method):
    """The reference draws these methods' Omega with jax.random: its
    checkpoint would merge a sketch from another random subspace."""
    monkeypatch.setattr(ref_resil, "AsyncWriter", _SyncWriter)
    faulty = ref_resil.FaultySource(rstream.ArraySource(matrix, TILE),
                                    fail_at_tile=3)
    with pytest.raises(ref_resil.FaultInjected):
        ref_rsvd.rsvd_streamed(JKEY, faulty, RANK, method=method,
                               checkpoint_dir=tmp_path,
                               checkpoint_every_tiles=EVERY, resume=True)
    with pytest.raises(RuntimeError, match=r"fingerprint mismatch.*\['omega'\]"):
        _job(method)(_src(matrix), checkpoint_dir=tmp_path,
                     checkpoint_every_tiles=EVERY, resume=True)


# ---------------------------------------------------------------------------
# SIGKILL and resume in a fresh process
# ---------------------------------------------------------------------------

_KILL_CHILD = (
    "import sys\n"
    "from repro_torch import main_path\n"
    "from repro_torch.convert import key_from_seed\n"
    "main_path.memmap_rsvd_job(key_from_seed(11), sys.argv[1], 8, tile_rows=16,\n"
    "    checkpoint_dir=sys.argv[2], checkpoint_every_tiles=4,\n"
    "    kill_at_tile=int(sys.argv[3]), device='cpu')\n")


def test_sigkill_and_resume_subprocess(matrix, tmp_path):
    """A child process SIGKILLs itself at tile 6 of the sketch pass (a real
    preemption); this process resumes from disk and gets the uninterrupted
    factors bit for bit.  The newest checkpoint may still have been in
    flight at the kill, so the bound on the recomputed tiles is
    every_tiles plus the tiles of one checkpoint in flight (2 x 4 here),
    never an exact cursor."""
    path = pipeline.write_matrix_npy(tmp_path / "a.npy", matrix)
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    dead = subprocess.run([sys.executable, "-c", _KILL_CHILD, str(path),
                           str(ckpt), "6"], env=env, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert dead.returncode == -9, (dead.returncode, dead.stderr[-2000:])
    assert (ckpt / "heartbeat.json").is_file()
    res, rep = main_path.memmap_rsvd_job(KEY := key_from_seed(11), path, 8,
                                         tile_rows=16, checkpoint_dir=ckpt,
                                         checkpoint_every_tiles=4,
                                         device="cpu")
    base = rsvd.rsvd_streamed(KEY, stream.MemmapSource(path, 16), 8,
                              device="cpu")
    assert _same(res, base)
    assert rep.attempts == 2 and len(rep.recovery_events) == 1
    assert rep.tiles_recomputed <= 2 * 4
    assert json.loads((ckpt / "resilience.json").read_text())["finished"] is True


# ---------------------------------------------------------------------------
# Fault injection primitives
# ---------------------------------------------------------------------------

def test_faulty_source_raise_then_passthrough(matrix):
    fs = resil.FaultySource(_src(matrix), fail_at_tile=2)
    got = []
    with pytest.raises(resil.FaultInjected):
        for t in fs.tiles():
            got.append(t)
    assert len(got) == 2
    np.testing.assert_array_equal(np.concatenate(list(fs.tiles())), matrix)


def test_faulty_source_counts_across_replays(matrix):
    fs = resil.FaultySource(_src(matrix), fail_at_tile=6 + 1)
    assert len(list(fs.tiles())) == 6
    with pytest.raises(resil.FaultInjected):
        list(fs.tiles_from(0))


def test_faulty_source_hang_then_yields(matrix):
    fs = resil.FaultySource(_src(matrix), fail_at_tile=1, mode="hang",
                            hang_secs=0.3)
    t0 = time.perf_counter()
    tiles = list(fs.tiles())
    assert time.perf_counter() - t0 >= 0.3
    np.testing.assert_array_equal(np.concatenate(tiles), matrix)


def test_faulty_source_validation(matrix):
    with pytest.raises(ValueError, match="mode"):
        resil.FaultySource(_src(matrix), fail_at_tile=0, mode="explode")
    with pytest.raises(ValueError, match="seed"):
        resil.FaultySource(_src(matrix))
    gen = stream.GeneratorSource(lambda: iter([matrix]), matrix.shape)
    with pytest.raises(ValueError, match="tile count"):
        resil.FaultySource(gen, seed=1)


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lose", [(1,), (0, 2)])
def test_elastic_host_loss_bitwise(matrix, lose):
    srcs = [stream.ArraySource(matrix[i * 32:(i + 1) * 32], TILE)
            for i in range(3)]
    full = resil.elastic_distributed_rsvd_streamed(KEY, srcs, RANK, device="cpu")
    res, rep = resil.elastic_distributed_rsvd_streamed(
        KEY, srcs, RANK, lose_hosts=lose, lose_after_tiles=1,
        return_report=True, device="cpu")
    assert _same(full, res)
    assert len(rep.recovery_events) == len(lose)
    assert rep.tiles_recomputed == len(lose) * (1 + 32 // TILE)
    assert 0.0 < rep.goodput < 1.0
    assert all(e["time_to_recover_s"] is not None for e in rep.recovery_events)
    assert _same(full, _job()(_src(matrix)))     # the same tiling on one host


def test_elastic_matches_reference(matrix):
    srcs = [matrix[i * 32:(i + 1) * 32] for i in range(3)]
    want = ref_resil.elastic_distributed_rsvd_streamed(
        JKEY, [rstream.ArraySource(s, TILE) for s in srcs], RANK,
        lose_hosts=(1,), lose_after_tiles=1)
    got = resil.elastic_distributed_rsvd_streamed(
        KEY, [stream.ArraySource(s, TILE) for s in srcs], RANK, lose_hosts=(1,),
        lose_after_tiles=1, device="cpu")
    np.testing.assert_allclose(_err(matrix, got), _ref_err(matrix, want), rtol=1e-3)


def test_elastic_and_row_range_errors(matrix):
    srcs = [stream.ArraySource(matrix[:48], TILE), stream.ArraySource(matrix[48:], TILE)]
    with pytest.raises(ValueError, match="passes >= 2"):
        resil.elastic_distributed_rsvd_streamed(KEY, srcs, RANK, passes=1,
                                                device="cpu")
    with pytest.raises(ValueError, match="survivors"):
        resil.elastic_distributed_rsvd_streamed(KEY, srcs, RANK,
                                                lose_hosts=(0, 1), device="cpu")
    with pytest.raises(ValueError, match="only 2"):
        resil.elastic_distributed_rsvd_streamed(KEY, srcs, RANK,
                                                lose_hosts=(5,), device="cpu")
    st = stream.init(KEY, N, 12, max_rows=M, method="shgemm_fused", device="cpu")
    with pytest.raises(ValueError, match="boundar"):
        resil.sketch_row_range(st, _src(matrix), 8, 32)        # r0 mid-tile
    with pytest.raises(ValueError, match="r1=40 is not a tile boundary"):
        resil.sketch_row_range(st, _src(matrix), 16, 40)
    with pytest.raises(ValueError, match="outside"):
        resil.sketch_row_range(st, _src(matrix), 0, M + TILE)


def test_sketch_row_range_replay_equals_one_pass(matrix):
    """Replaying [32, 96) of a source that covers global rows [16, 112) in
    two chunks writes the one-pass sketch's rows bit for bit."""
    one = stream.init(KEY, N, 12, max_rows=128, method="shgemm_fused", device="cpu")
    resil.sketch_row_range(one, _src(matrix), 32, 96, src_row0=16)
    two = stream.init(KEY, N, 12, max_rows=128, method="shgemm_fused", device="cpu")
    for a, b in resil.partition_rows(32, 96, 2, tile_rows=TILE):
        resil.sketch_row_range(two, _src(matrix), a, b, src_row0=16,
                               prefetch_depth=None)
    assert torch.equal(one.y, two.y) and one.rows_seen == two.rows_seen == 96
    assert not one.y[:32].any() and not one.y[96:].any()
