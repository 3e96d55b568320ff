"""core/distributed.py, launch/mesh.py and stream.merge_across_hosts against
the reference, on the same numpy inputs.

The reference's distributed functions need a multi-device JAX mesh, which
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` gives only before JAX
starts, so the reference runs once in a subprocess (as
``tests/test_distributed_core.py`` runs it) and saves its outputs, turned
into numpy before anything multiplies them, in an ``.npz``.  The port runs
in gloo worlds of local processes on the CPU (``launch.world.run_world``,
a ``FileStore`` in a temporary directory): 2 x 2 ranks at 256 x 256, and the
reference test's 4 x 2 at 512 x 512.  The ranks' code is in
``torch_dist_workers.py``, which imports no JAX; the reference's jax.random
Omega and Psi key words reach the ranks as arguments.

Tolerances are the reference tests': relative reconstruction error < 1e-4
and singular values at rtol 1e-2 against the single-process rSVD, Q^T Q at
atol 1e-4, power iterations within 1.02x the Eckart-Young floor
(``test_distributed_core.py``); the merged left sketch at rtol/atol 1e-6
against the single-host one and the streamed factors at rtol 1e-4 / atol
1e-5 (``test_distributed_stream.py``); rows of a sketch across the packages
at the streamed rows' rtol 1e-5 / atol 1e-4 (``test_torch_stream_state.py``).
Within the port: SPMD replicas agree bit for bit, a merge of disjoint rows
equals the single-host sketch bit for bit, a resumed streamed job equals
the uninterrupted one bit for bit.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import stream
from repro_torch.core import distributed as D, projection as proj, rsvd
from repro_torch.launch import mesh as mesh_mod, world
from repro_torch.launch.mesh import HostMesh
from repro_torch.stream import resilience as resil, state as st_mod

torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 120.0     # a deadlocked collective fails its test
KEY0 = (0, 0)

_REFERENCE = textwrap.dedent("""
    import sys, time
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro import stream
    from repro.core import distributed as D, rsvd
    from repro.core.projection import gaussian
    from repro.stream import state as ref_state, resilience as ref_resil

    out = {}
    devs = np.array(jax.devices())
    assert len(devs) == 8

    def f32(x):
        return np.asarray(x).astype(np.float32)

    def mesh_case(tag, mesh, n, rank):
        p_hat = rank + 10
        a = rsvd.matrix_with_singular_values(
            jax.random.PRNGKey(0), n, rsvd.singular_values_exp(n, rank, 1e-5))
        a_sh = D.shard_matrix(a, mesh)
        out[tag + ".a"] = f32(a)
        for method in ("shgemm", "shgemm_fused"):
            res = D.distributed_rsvd(jax.random.PRNGKey(1), a_sh, rank, mesh,
                                     method=method)
            for f in ("u", "s", "vt"):
                out[f"{tag}.rsvd.{method}.{f}"] = f32(getattr(res, f))
            one = rsvd.rsvd(jax.random.PRNGKey(1), a, rank, method=method)
            out[f"{tag}.rsvd1.{method}.s"] = f32(one.s)
            q = D.distributed_range_finder(jax.random.PRNGKey(2), a_sh, p_hat,
                                           mesh, method=method)
            out[f"{tag}.q.{method}"] = f32(q)
        s_flat = rsvd.singular_values_linear(n, rank, 0.5)
        a2 = rsvd.matrix_with_singular_values(jax.random.PRNGKey(3), n, s_flat)
        out[tag + ".a2"] = f32(a2)
        out[tag + ".s_flat"] = f32(s_flat)
        a2_sh = D.shard_matrix(a2, mesh)
        for it in (0, 2):
            res = D.distributed_rsvd(jax.random.PRNGKey(4), a2_sh, rank, mesh,
                                     power_iters=it)
            for f in ("u", "s", "vt"):
                out[f"{tag}.power{it}.{f}"] = f32(getattr(res, f))
        for seed in (1, 2, 4):
            out[f"{tag}.omega{seed}"] = f32(gaussian(
                jax.random.PRNGKey(seed), (n, p_hat), dtype=jnp.bfloat16))

    mesh_case("w8", jax.make_mesh((4, 2), ("data", "model")), 512, 48)
    mesh_case("w4", Mesh(devs[:4].reshape(2, 2), ("data", "model")), 256, 24)

    # merge_across_hosts: tests/test_distributed_stream.py's case
    hosts = Mesh(devs[:2], ("hosts",))
    key = jax.random.PRNGKey(0)
    m, n, rank = 128, 96, 12
    a = jax.random.normal(jax.random.fold_in(key, 1), (m, n), jnp.float32)
    out["hosts.a"] = f32(a)
    p_hat = rank + 10
    states = []
    for lo, hi, tile in [(0, 64, 24), (64, 128, 32)]:
        st = stream.init(key, n, p_hat, max_rows=m, left=True)
        for off in range(lo, hi, tile):
            st = stream.update(st, a[off:off + min(tile, hi - off)], off)
        states.append(st)
    merged = D._shard_map_stack(
        lambda st: stream.merge_across_hosts(st, "hosts"), states, hosts,
        "hosts")
    out["hosts.merged.y"] = f32(merged.y)
    out["hosts.merged.w"] = f32(merged.w)
    out["hosts.key_psi"] = np.asarray(
        ref_state._raw_key(jax.random.fold_in(key, 0x5117))).astype(np.uint32)

    # distributed_rsvd_streamed, and a checkpoint left by a fault in host
    # 1's second tile
    srcs = [stream.ArraySource(np.asarray(a[:64]), 24),
            stream.ArraySource(np.asarray(a[64:]), 24)]
    for passes in (2, 4):
        res = D.distributed_rsvd_streamed(key, srcs, rank, hosts,
                                          data_axis="hosts", passes=passes)
        for f in ("u", "s", "vt"):
            out[f"stream{passes}.{f}"] = f32(getattr(res, f))
    faulty = [srcs[0], ref_resil.FaultySource(srcs[1], fail_at_tile=1)]
    try:
        D.distributed_rsvd_streamed(key, faulty, rank, hosts,
                                    data_axis="hosts", checkpoint_dir=sys.argv[2],
                                    checkpoint_every_tiles=1)
        raise SystemExit("the fault did not fire")
    except ref_resil.FaultInjected:
        pass
    time.sleep(1.0)   # the reference leaves its last checkpoint write in flight
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "ref.npz"),
                          str(tmp / "ckpt")], env=env, capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0 and "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    with np.load(tmp / "ref.npz") as f:
        doc = {k: f[k] for k in f.files}
    doc["ckpt"] = tmp / "ckpt"
    return doc


CASES = {"w4": dict(sizes=(2, 2), n=256, rank_k=24,
                    methods=("shgemm", "shgemm_fused", "shgemm_pallas")),
         "w8": dict(sizes=(4, 2), n=512, rank_k=48,
                    methods=("shgemm", "shgemm_fused"))}


@pytest.fixture(scope="module")
def worlds(ref):
    """Each case's gloo world, run once: the ranks' outputs in rank order."""
    out = {}
    for tag, case in CASES.items():
        omegas = {(0, s): ref[f"{tag}.omega{s}"] for s in (1, 2, 4)}
        out[tag] = world.run_world(
            "torch_dist_workers:mesh_case", int(np.prod(case["sizes"])),
            kwargs=dict(sizes=case["sizes"], a=ref[f"{tag}.a"],
                        a2=ref[f"{tag}.a2"], rank_k=case["rank_k"],
                        omegas=omegas, methods=case["methods"]),
            device="cpu", timeout=WORLD_TIMEOUT)
    return out


def _gather(outs, what):
    """The global (U, s, Vt) of a ShardedSVD from the ranks' blocks: U's
    rows from the data axis, Vt's columns from the model axis."""
    dp = 1 + max(o["index"][0] for o in outs)
    mp = 1 + max(o["index"][1] for o in outs)
    by = {o["index"]: o[what] for o in outs}
    u = np.concatenate([by[(i, 0)][0] for i in range(dp)])
    vt = np.concatenate([by[(0, j)][2] for j in range(mp)], axis=1)
    return u, by[(0, 0)][1], vt


def _relerr(a, u, s, vt):
    return float(np.linalg.norm(a - (u * s[None, :]) @ vt) / np.linalg.norm(a))


def _ref_method(method):
    return "shgemm" if method == "shgemm_pallas" else method


RSVD_CASES = [(t, m) for t, c in CASES.items() for m in c["methods"]]


@pytest.mark.parametrize("tag,method", RSVD_CASES)
def test_distributed_rsvd_matches_reference(ref, worlds, tag, method):
    rank_k = CASES[tag]["rank_k"]
    u, s, vt = _gather(worlds[tag], ("rsvd", method))
    a = ref[f"{tag}.a"]
    assert u.shape == (a.shape[0], rank_k) and vt.shape == (rank_k, a.shape[1])
    err = _relerr(a, u, s, vt)
    assert err < 1e-4, err      # TSQR of B^T: single-device accuracy
    rm = _ref_method(method)
    err_ref = _relerr(a, ref[f"{tag}.rsvd.{rm}.u"], ref[f"{tag}.rsvd.{rm}.s"],
                      ref[f"{tag}.rsvd.{rm}.vt"])
    assert err_ref < 1e-4
    np.testing.assert_allclose(s[:16], ref[f"{tag}.rsvd1.{rm}.s"][:16], rtol=1e-2)
    np.testing.assert_allclose(s[:16], ref[f"{tag}.rsvd.{rm}.s"][:16], rtol=1e-2)
    # the port's own single-process rSVD under the same Omega
    if rm == "shgemm":
        one = _one_process_rsvd(ref, tag, method)
        np.testing.assert_allclose(s[:16], one[:16], rtol=1e-2)


def _one_process_rsvd(ref, tag, method):
    omega = torch.from_numpy(ref[f"{tag}.omega1"]).to(torch.bfloat16)
    a = torch.from_numpy(ref[f"{tag}.a"])
    y = proj.project(a, omega, method=method, device="cpu")
    q, _ = torch.linalg.qr(y)
    return torch.linalg.svdvals(q.T @ a).numpy()


@pytest.mark.parametrize("tag,method", RSVD_CASES)
def test_distributed_range_finder_matches_reference(ref, worlds, tag, method):
    outs = worlds[tag]
    dp = 1 + max(o["index"][0] for o in outs)
    by = {o["index"]: o[("q", method)] for o in outs}
    q = np.concatenate([by[(i, 0)] for i in range(dp)])
    p_hat = CASES[tag]["rank_k"] + 10
    np.testing.assert_allclose(q.T @ q, np.eye(p_hat), atol=1e-4)
    q_ref = ref[f"{tag}.q.{_ref_method(method)}"]
    a = ref[f"{tag}.a"]

    def proj_err(q_):
        return np.linalg.norm(a - q_ @ (q_.T @ a)) / np.linalg.norm(a)
    np.testing.assert_allclose(proj_err(q), proj_err(q_ref), rtol=1e-2,
                               atol=1e-6)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_distributed_power_iterations(ref, worlds, tag):
    """The flat spectrum closes in on the Eckart-Young floor, as the
    reference's does (same Omega)."""
    a2, s_flat = ref[f"{tag}.a2"], ref[f"{tag}.s_flat"]
    rank_k = CASES[tag]["rank_k"]
    floor = np.linalg.norm(s_flat[rank_k:]) / np.linalg.norm(s_flat)
    e0 = _relerr(a2, *_gather(worlds[tag], ("power", 0)))
    e2 = _relerr(a2, *_gather(worlds[tag], ("power", 2)))
    assert e2 < e0
    assert e2 < 1.02 * floor, (e2, floor)
    for it, e in ((0, e0), (2, e2)):
        want = _relerr(a2, *(ref[f"{tag}.power{it}.{f}"] for f in ("u", "s", "vt")))
        np.testing.assert_allclose(e, want, rtol=1e-2)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_spmd_replicas_agree(worlds, tag):
    """U is replicated over the model axis, Vt over data, s everywhere: the
    ranks that hold a replica hold the same bits."""
    outs = worlds[tag]
    assert [o["coords"] for o in outs] == [o["index"] for o in outs]
    for method in CASES[tag]["methods"]:
        by = {o["index"]: o[("rsvd", method)] for o in outs}
        for (i, j), (u, s, vt) in by.items():
            np.testing.assert_array_equal(u, by[(i, 0)][0])
            np.testing.assert_array_equal(vt, by[(0, j)][2])
            np.testing.assert_array_equal(s, by[(0, 0)][1])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_kernel2_block_at_row_offset(ref, worlds, tag):
    """Each rank's kernel-2 product at row offset model_index * n_loc is its
    block times the matching rows of the materialized lattice Omega, and the
    sum over the model axis is the one-process fused sketch (rel < 1e-5, the
    reference test's bound)."""
    outs = worlds[tag]
    a = torch.from_numpy(ref[f"{tag}.a"])
    dp, mp = CASES[tag]["sizes"]
    m_loc, n_loc = a.shape[0] // dp, a.shape[1] // mp
    p_hat = CASES[tag]["rank_k"] + 10
    omega = proj.fused_omega((0, 2), (a.shape[1], p_hat), device="cpu")
    y_rows = {}
    for o in outs:
        i, j = o["index"]
        assert o["row_offset"] == j * n_loc
        blk = a[i * m_loc:(i + 1) * m_loc, j * n_loc:(j + 1) * n_loc]
        want = proj.project(blk, omega[j * n_loc:(j + 1) * n_loc],
                            method="shgemm_pallas", device="cpu")
        torch.testing.assert_close(torch.from_numpy(o["y_local"]), want,
                                   rtol=1e-5, atol=1e-4)
        y_rows[i] = y_rows.get(i, 0) + o["y_local"]
    y = np.concatenate([y_rows[i] for i in range(dp)])
    y_one = proj.sketch((0, 2), a, p_hat, method="shgemm_fused", device="cpu").numpy()
    assert np.linalg.norm(y - y_one) / np.linalg.norm(y_one) < 1e-5


# --------------------------------------------------------------------------
# merge_across_hosts (a world of two hosts)
# --------------------------------------------------------------------------

SPLIT = [(0, 64, 24), (64, 128, 32)]


@pytest.fixture(scope="module")
def merged(ref):
    return world.run_world(
        "torch_dist_workers:merge_case", 2,
        kwargs=dict(a=ref["hosts.a"], split=SPLIT, p_hat=22,
                    psi_words=ref["hosts.key_psi"], bad_key=(0, 9)),
        device="cpu", timeout=WORLD_TIMEOUT)


def _single_host(ref, monkeypatch):
    words = tuple(int(w) for w in ref["hosts.key_psi"])
    monkeypatch.setattr(st_mod, "fold_in_words", lambda key, data: words)
    a = ref["hosts.a"]
    seq = stream.init(KEY0, a.shape[1], 22, max_rows=a.shape[0], left=True,
                      method="shgemm_fused", device="cpu")
    for lo, hi, tile in SPLIT:
        for off in range(lo, hi, tile):
            stream.update(seq, torch.from_numpy(a[off:min(off + tile, hi)]), off)
    return seq


def test_merge_across_hosts_equals_single_host(ref, merged, monkeypatch):
    seq = _single_host(ref, monkeypatch)
    for out in merged:                     # every rank holds the merge
        np.testing.assert_array_equal(out["y"], seq.y.numpy())   # bit for bit
        np.testing.assert_allclose(out["w"], seq.w.numpy(), rtol=1e-6, atol=1e-6)
        assert out["rows_seen"] == 128
    np.testing.assert_array_equal(merged[0]["y"], merged[1]["y"])


def test_merge_across_hosts_matches_reference(ref, merged):
    """Across the packages each row of the sketch is a GEMM the two
    frameworks sum in their own order, so the rows agree at the streamed
    rows' parity tolerance (``test_torch_stream_state.py``), not at the
    1e-6 that holds within one package (above)."""
    np.testing.assert_allclose(merged[0]["y"], ref["hosts.merged.y"],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(merged[0]["w"], ref["hosts.merged.w"],
                               rtol=1e-5, atol=1e-4)


def test_merge_across_hosts_poisons_mismatched_keys(merged):
    for out in merged:
        assert np.isnan(out["poisoned_y"]).all()
        assert np.isnan(out["poisoned_w"]).all()


# --------------------------------------------------------------------------
# distributed_rsvd_streamed (one controller)
# --------------------------------------------------------------------------

HOSTS = HostMesh((2,), ("hosts",))     # unbound: names and sizes


def _sources(a, tile=24):
    return [stream.ArraySource(a[:64], tile), stream.ArraySource(a[64:], tile)]


def _streamed(a, **kw):
    return D.distributed_rsvd_streamed(KEY0, _sources(a), 12, HOSTS,
                                       data_axis="hosts", device="cpu", **kw)


def _aligned(res, u_ref):
    """(u, s, vt) with each singular pair's sign matched to ``u_ref``'s."""
    u, s, vt = (x.numpy() for x in res)
    signs = np.sign(np.sum(u * u_ref, axis=0))
    return u * signs, s, vt * signs[:, None]


def _assert_factors(res, ref, tag):
    u, s, vt = _aligned(res, ref[f"{tag}.u"])
    np.testing.assert_allclose(u, ref[f"{tag}.u"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s, ref[f"{tag}.s"], rtol=1e-5)
    np.testing.assert_allclose(vt, ref[f"{tag}.vt"], rtol=1e-4, atol=1e-5)


def test_streamed_matches_reference(ref):
    _assert_factors(_streamed(ref["hosts.a"]), ref, "stream2")


def test_streamed_power_passes_match_reference(ref):
    """passes=4 against the reference's passes=4, held as the reference
    test holds it (reconstruction error within 1e-5): two more passes of
    QR and GEMM in each framework's own order."""
    a = ref["hosts.a"]
    got = float(rsvd.reconstruction_error(torch.from_numpy(a),
                                          _streamed(a, passes=4)))
    want = _relerr(a, *(ref[f"stream4.{f}"] for f in ("u", "s", "vt")))
    assert abs(got - want) <= 1e-5, (got, want)


def test_streamed_accuracy_against_in_core(ref):
    """passes=2 is the in-core fused rSVD's accuracy, passes=4 its
    power_iters=1 accuracy (test_distributed_stream.py's bounds)."""
    a = torch.from_numpy(ref["hosts.a"])
    err2 = float(rsvd.reconstruction_error(a, _streamed(a.numpy())))
    err4 = float(rsvd.reconstruction_error(a, _streamed(a.numpy(), passes=4)))
    one = rsvd.rsvd(KEY0, a, 12, method="shgemm_fused", device="cpu")
    one1 = rsvd.rsvd(KEY0, a, 12, method="shgemm_fused", power_iters=1,
                     device="cpu")
    assert abs(err2 - float(rsvd.reconstruction_error(a, one))) <= 1e-5
    assert abs(err4 - float(rsvd.reconstruction_error(a, one1))) <= 1e-5
    assert err4 <= err2 * 1.02 + 2e-7


def _last_checkpoint_array(ckdir: Path, name: str) -> np.ndarray:
    last = sorted(p for p in ckdir.glob("ckpt_*") if p.is_dir())[-1]
    return np.load(last / f"{name}.npy")


def test_streamed_sketch_equals_single_host_bitwise(ref, tmp_path):
    """The merged pass-1 sketch (the job's last checkpoint at passes=2) is
    single-host ``rsvd_streamed``'s of the same tiles, bit for bit; the
    checkpointed job returns the plain job's factors bit for bit."""
    a = ref["hosts.a"]
    plain = _streamed(a)
    ck = _streamed(a, checkpoint_dir=tmp_path / "d", checkpoint_every_tiles=2)
    for x, y in zip(plain, ck):
        assert torch.equal(x, y)
    tiles = [a[off:min(off + 24, hi)] for lo, hi in ((0, 64), (64, 128))
             for off in range(lo, hi, 24)]
    rsvd.rsvd_streamed(KEY0, tiles, 12, n_rows=128, n_cols=96, device="cpu",
                       checkpoint_dir=tmp_path / "s", checkpoint_every_tiles=100)
    np.testing.assert_array_equal(_last_checkpoint_array(tmp_path / "d", "done.y"),
                                  _last_checkpoint_array(tmp_path / "s", "state.y"))


@pytest.mark.parametrize("fail_at", [1, 4, 8])
def test_streamed_resume_bitwise(ref, tmp_path, fail_at):
    """A raised fault in host 0's sketch, host 1's sketch or the B pass,
    then a resume: the uninterrupted job's factors bit for bit."""
    a = ref["hosts.a"]
    want = _streamed(a)
    srcs = _sources(a)
    h, t = (0, fail_at) if fail_at < 3 else (1, fail_at - 3)
    srcs[h] = resil.FaultySource(srcs[h], fail_at_tile=t)
    with pytest.raises(resil.FaultInjected):
        D.distributed_rsvd_streamed(KEY0, srcs, 12, HOSTS, data_axis="hosts",
                                    checkpoint_dir=tmp_path, device="cpu",
                                    checkpoint_every_tiles=1)
    got, rep = _streamed(a, checkpoint_dir=tmp_path, checkpoint_every_tiles=1,
                         resume=True, return_report=True)
    for x, y in zip(want, got):
        assert torch.equal(x, y)
    assert rep.attempts == 2


def test_reference_checkpoint_resumed_by_port(ref, tmp_path):
    """The reference's job, killed by a fault in host 1's second tile,
    finishes in the port: its factors at the streamed tolerance."""
    ck = tmp_path / "ckpt"
    shutil.copytree(ref["ckpt"], ck)
    restored = resil.SketchJobCheckpointer(ck, resume=True, fingerprint={
        "job": "distributed_rsvd_streamed", "key": [0, 0], "rank": 12,
        "p_hat": 22, "passes": 2, "method": "shgemm_fused",
        "omega_dtype": "bfloat16", "n_rows": 128, "n_cols": 96,
        "hosts": 2}).restore()
    assert restored.phase == "dist-sketch"
    assert {"done.y", "cur.y"} <= set(restored.arrays)
    res = _streamed(ref["hosts.a"], checkpoint_dir=ck, checkpoint_every_tiles=1,
                    resume=True)
    _assert_factors(res, ref, "stream2")


def test_streamed_validation(ref):
    a = ref["hosts.a"]
    with pytest.raises(ValueError, match="mesh axis"):
        D.distributed_rsvd_streamed(KEY0, _sources(a)[:1], 12, HOSTS,
                                    data_axis="hosts", device="cpu")
    gen = stream.GeneratorSource(iter([a[:64]]), (64, 96))
    with pytest.raises(ValueError, match="replay"):
        D.distributed_rsvd_streamed(KEY0, [gen, _sources(a)[1]], 12, HOSTS,
                                    data_axis="hosts", device="cpu")
    with pytest.raises(ValueError, match="passes >= 2"):
        _streamed(a, passes=1)
    with pytest.raises(ValueError, match="resume=True needs checkpoint_dir"):
        _streamed(a, resume=True)


# --------------------------------------------------------------------------
# HostMesh and the world launcher
# --------------------------------------------------------------------------

def test_host_mesh_rank_order():
    """Ranks in jax.make_mesh's order: rank = data_index * model + model_index."""
    m = HostMesh((4, 2))
    assert m.shape == {"data": 4, "model": 2} and m.world_size == 8
    assert [m.coords(r) for r in range(8)] == [(i, j) for i in range(4)
                                               for j in range(2)]
    assert m.lines("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.lines("data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert HostMesh((2,), ("hosts",)).lines("hosts") == [[0, 1]]


def test_host_mesh_errors():
    m = HostMesh((2, 2))
    assert not m.bound and m.size("model") == 2
    with pytest.raises(RuntimeError, match="not bound"):
        m.index("data")
    with pytest.raises(RuntimeError, match="not bound"):
        m.group("data")
    with pytest.raises(ValueError, match="no axis"):
        m.size("pod")
    with pytest.raises(ValueError, match="axis names"):
        HostMesh((2, 2), ("data",))
    with pytest.raises(ValueError, match=">= 1"):
        HostMesh((0, 2))
    with pytest.raises(RuntimeError, match="init_process_group"):
        m.bind()
    solo = mesh_mod.make_host_mesh()
    assert solo.shape == {"data": 1, "model": 1} and not solo.bound


def test_nccl_needs_a_card_a_rank():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("enough cards for two NCCL ranks")
    with pytest.raises(RuntimeError, match="one CUDA card a rank"):
        mesh_mod.check_backend("nccl", 2)
    with pytest.raises(RuntimeError, match="one CUDA card a rank"):
        world.run_world("torch_dist_workers:fail_case", 2, backend="nccl",
                        kwargs={"hang": False})
    mesh_mod.check_backend("gloo", 64)


@pytest.mark.parametrize("hang", [False, True])
def test_run_world_fails_loudly(hang):
    """A rank that raises, or a collective that never completes, fails the
    world within its timeout; every rank is stopped."""
    with pytest.raises(RuntimeError,
                       match="timed out" if hang else "fails on purpose"):
        world.run_world("torch_dist_workers:fail_case", 2,
                        kwargs={"hang": hang}, device="cpu",
                        timeout=20.0 if hang else WORLD_TIMEOUT)
