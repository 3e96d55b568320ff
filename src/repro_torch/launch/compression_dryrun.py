"""Wire bytes of the paper-technique data-parallel compression on the
multi-pod mesh (port of ``repro/launch/compression_dryrun.py``).

Runs two gradient reductions as rank 0 of a fake world of the (2, 16, 16)
production mesh, on fake tensors (``launch/dryrun.py``), and counts the
bytes each hands to its collectives:

  raw:      g_reduced = all_reduce(g, "pod")                (full f32 grads)
  sketched: Q = qr(Omega); all_reduce(Q_bf16^T g, "pod")    (rank-r sketch,
            un-projected locally by Q)

g is an (8192, 4096) f32 gradient whose columns are split over ("data",
"model"), so a rank holds (8192, 16).  The wire ratio is d / r exactly: the
paper's random projection applied to the distributed optimizer's reduce.

    PYTHONPATH=src python -m repro_torch.launch.compression_dryrun
"""

from __future__ import annotations

import torch

from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import HostMesh
from repro_torch.sharding import activation as A


def wire(coll: dict) -> int:
    """Bytes a rank puts on the wire: an all-reduce moves about twice its
    result (ring reduce-scatter + all-gather), the others once."""
    return (coll["all-gather"] + 2 * coll["all-reduce"]
            + coll["reduce-scatter"] + coll["all-to-all"]
            + coll["collective-permute"])


def main(d: int = 8192, cols: int = 4096, rank: int = 64) -> list:
    from torch._subclasses.fake_tensor import FakeTensorMode
    prod = mesh_mod.make_production_mesh(multi_pod=True)

    def raw(g, mesh):
        return A.all_reduce(g, mesh, "pod")

    def sketched(g, mesh):
        q, _ = torch.linalg.qr(torch.randn(d, rank))
        sk = q.to(torch.bfloat16).T.float() @ g
        return q @ A.all_reduce(sk, mesh, "pod")  # rank-r rows on the wire

    rows = []
    with DR.fake_world(prod.world_size):
        mesh = HostMesh(prod.sizes, prod.axis_names).bind()
        with FakeTensorMode():
            g = torch.empty(d, cols // mesh.size(("data", "model")))
            for name, fn in (("raw_psum", raw), ("sketched_psum", sketched)):
                with DR.CollectiveCounter() as counter:
                    out = fn(g, mesh)
                if tuple(out.shape) != tuple(g.shape):
                    raise RuntimeError(f"{name} returned {tuple(out.shape)}")
                rows.append((name, wire(counter.bytes)))
                print(f"{name:14s} wire={rows[-1][1] / 1e6:10.4f} MB/device  "
                      f"({counter.bytes})")
    ratio = rows[0][1] / max(rows[1][1], 1)
    print(f"wire reduction: {ratio:.1f}x  (d/r = {d / rank:.0f})")
    return rows


if __name__ == "__main__":
    main()
