"""Rank functions of the port's distributed tests (``test_torch_distributed.py``).

``repro_torch.launch.world.run_world`` imports this module in each rank's
process, so it imports no JAX: the reference's draws reach the ranks as numpy
arrays in the keyword arguments and are patched in here, inside each rank
(a ``monkeypatch`` of the test process does not cross into them).
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import stream
from repro_torch.core import distributed as D, projection as proj
from repro_torch.launch.mesh import HostMesh
from repro_torch.stream import state as st_mod

torch.set_flush_denormal(True)   # XLA's CPU backend flushes subnormals


def _serve_omegas(omegas: dict) -> None:
    """``projection.materialize_omega`` := the reference's jax.random Omega
    of the same key words (given as f32 arrays, exact bf16 values)."""
    def materialize(key, shape, *, dist="gaussian", s=None,
                    dtype=torch.bfloat16, device=None):
        omega = omegas[tuple(int(w) for w in key)]
        if tuple(omega.shape) != tuple(shape) or dist != "gaussian":
            raise AssertionError(f"no reference Omega for {key} {shape} {dist}")
        return torch.from_numpy(omega).to(dtype).to(device)
    proj.materialize_omega = materialize


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def mesh_case(rank, world, dev, *, sizes, a, a2, rank_k, omegas, methods,
              power_iters=(0, 2)):
    """distributed_rsvd / distributed_range_finder on this rank's block of
    ``a`` for each method, power iterations on ``a2``, and this rank's
    unreduced kernel-2 block beside its Omega row offset."""
    _serve_omegas(omegas)
    mesh = HostMesh(sizes).bind()
    p_hat = rank_k + 10
    a_blk = D.shard_matrix(torch.from_numpy(a), mesh).to(dev)
    out = {"coords": mesh.coords(rank),
           "index": (mesh.index("data"), mesh.index("model"))}
    for method in methods:
        res = D.distributed_rsvd((0, 1), a_blk, rank_k, mesh, method=method)
        out[("rsvd", method)] = tuple(_np(x) for x in res)
        q = D.distributed_range_finder((0, 2), a_blk, p_hat, mesh,
                                       method=method)
        out[("q", method)] = _np(q)
    a2_blk = D.shard_matrix(torch.from_numpy(a2), mesh).to(dev)
    for it in power_iters:
        res = D.distributed_rsvd((0, 4), a2_blk, rank_k, mesh, power_iters=it)
        out[("power", it)] = tuple(_np(x) for x in res)
    # kernel 2 at this rank's Omega row offset, before the model-axis sum
    from repro_torch.kernels import ops
    n_loc = a_blk.shape[1]
    out["row_offset"] = mesh.index("model") * n_loc
    out["y_local"] = _np(ops.shgemm_fused(a_blk, (0, 2), p_hat,
                                          row_offset=out["row_offset"],
                                          device=dev))
    return out


def merge_case(rank, world, dev, *, a, split, p_hat, psi_words, bad_key):
    """Each host sketches its row range (left sketch too) and the states
    merge across the hosts; then again with host 1 under ``bad_key``."""
    st_mod.fold_in_words = lambda key, data: tuple(int(w) for w in psi_words)
    mesh = HostMesh((world,), ("hosts",)).bind()
    m, n = a.shape
    lo, hi, tile = split[rank]

    def host_state(key):
        st = stream.init(key, n, p_hat, max_rows=m, left=True,
                         method="shgemm_fused", device=dev)
        for off in range(lo, hi, tile):
            stream.update(st, torch.from_numpy(a[off:min(off + tile, hi)]), off)
        return st

    merged = stream.merge_across_hosts(host_state((0, 0)), mesh.group("hosts"))
    poisoned = stream.merge_across_hosts(
        host_state((0, 0) if rank == 0 else bad_key), mesh.group("hosts"))
    return {"y": _np(merged.y), "w": _np(merged.w),
            "rows_seen": merged.rows_seen,
            "poisoned_y": _np(poisoned.y), "poisoned_w": _np(poisoned.w)}


def fail_case(rank, world, dev, *, hang):
    """Rank 1 raises (``hang=False``), or sleeps while rank 0 waits for it
    in a collective (``hang=True``)."""
    if rank == 1:
        if hang:
            time.sleep(600)
        raise ValueError("rank 1 fails on purpose")
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)


def rsvd_case(rank, world, dev, *, sizes, a, rank_k, method):
    """distributed_rsvd on this rank's block of ``a``; the global relative
    error (summed over the world) and the singular values."""
    from repro_torch.kernels.ref import dot_f32
    mesh = HostMesh(sizes).bind()
    a_blk = D.shard_matrix(torch.from_numpy(a), mesh).to(dev)
    res = D.distributed_rsvd((0, 1), a_blk, rank_k, mesh, method=method)
    sq = torch.stack([(a_blk - dot_f32(res.u * res.s, res.vt)).square().sum(),
                      a_blk.square().sum()])
    dist.all_reduce(sq)
    return {"err": float(torch.sqrt(sq[0] / sq[1])), "s": _np(res.s)}


def compression_case(rank, world, dev, *, grads, rank_k):
    """``optim.compression`` over the world's group: one step of
    ``compress_and_reduce`` on this rank's gradients, and the microbatch path
    on them in two halves."""
    from repro_torch.optim import compression

    mine = {k: torch.from_numpy(v.copy()).to(dev) for k, v in grads[rank].items()}
    group = dist.group.WORLD
    st = compression.init_state(mine)
    red, new_st = compression.compress_and_reduce(mine, st, rank=rank_k,
                                                  group=group)
    ms = compression.begin_accumulation(st, mine, rank=rank_k)
    for half in (0.25, 0.75):
        ms = compression.accumulate_microbatch(
            ms, {k: g * half for k, g in mine.items()})
    red_mb, _ = compression.finish_accumulation(ms, group=group)
    return {"oneshot": {k: v.cpu() for k, v in red.items()},
            "micro": {k: v.cpu() for k, v in red_mb.items()},
            "residual": {k: v.cpu() for k, v in new_st.residual.items()
                         if v is not None}}
