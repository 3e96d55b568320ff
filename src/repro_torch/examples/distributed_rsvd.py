"""Distributed RSVD on a (data, model) mesh — sharded projection + TSQR
(DESIGN.md §6).  The reference forces 8 virtual host devices into a (4, 2)
mesh; here a (4, 2) world of 8 local processes runs over gloo
(``launch/world.py:run_world``), every rank on the one card (or on the CPU
under ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.examples.distributed_rsvd [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.convert import key_from_seed
from repro_torch.core import distributed as D, rsvd
from repro_torch.device import resolve_device
from repro_torch.examples import add_common_args
from repro_torch.kernels.ref import dot_f32
from repro_torch.launch import world
from repro_torch.launch.mesh import HostMesh

MESH = (4, 2)
N, RANK = 1024, 64


def rank_main(rank, world_size, dev, *, a, key):
    """One rank: its block of ``a``, ``distributed_rsvd``, and the global
    relative error (the squared norms summed over the world)."""
    mesh = HostMesh(MESH).bind()
    a_blk = D.shard_matrix(a, mesh).to(dev)
    res = D.distributed_rsvd(key, a_blk, RANK, mesh)
    sq = torch.stack([(a_blk - dot_f32(res.u * res.s[None, :], res.vt))
                      .square().sum(), a_blk.square().sum()])
    dist.all_reduce(sq)
    return {"rel_err": float(torch.sqrt(sq[0] / sq[1])),
            "s": res.s.cpu(), "a_block": tuple(a_blk.shape),
            "u_block": tuple(res.u.shape), "vt_block": tuple(res.vt.shape)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.distributed_rsvd")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = HostMesh(MESH)
    print(f"ranks: {mesh.world_size} processes on {dev.type}, mesh: "
          f"{mesh.shape}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a = rsvd.matrix_with_singular_values(
        gen, N, rsvd.singular_values_exp(N, RANK, 1e-5, device=dev))
    key = key_from_seed(args.seed + 1)
    outs = world.run_world("repro_torch.examples.distributed_rsvd:rank_main",
                           mesh.world_size, kwargs={"a": a.cpu(), "key": key},
                           device=dev.type, timeout=300.0)
    r0 = outs[0]
    print(f"A sharding: rows over data, columns over model; block "
          f"{r0['a_block']} a rank")
    print(f"distributed rsvd rank {RANK}: rel_err={r0['rel_err']:.3e}")
    print(f"U sharding: rows over data, block {r0['u_block']}  V^T sharding: "
          f"columns over model, block {r0['vt_block']}")

    ref = rsvd.rsvd(key, a, RANK, device=dev)
    s_dist = [float(x) for x in r0["s"][:5]]
    s_one = [float(x) for x in ref.s[:5]]
    print("sigma (distributed):", [f"{x:.4f}" for x in s_dist])
    print("sigma (one process):", [f"{x:.4f}" for x in s_one])
    return {"rel_err": r0["rel_err"], "sigma": s_dist, "sigma_one": s_one,
            "rank_errs": [o["rel_err"] for o in outs]}


if __name__ == "__main__":
    main()
