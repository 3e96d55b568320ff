"""Embedding-table compression with mixed-precision RSVD (DESIGN.md §4.4).

The offline 1000-node RandNLA job in miniature: factor a (V, D) embedding
table as U_r S_r V_r^T at several ranks and report memory vs. retrieval
quality (top-1 nearest-neighbour agreement under the compressed table) —
the projection GEMM is the paper's SHGEMM.

    PYTHONPATH=src python -m repro_torch.examples.embedding_compression [--device cpu]

``--vocab 151936 --dim 1024`` is qwen3-0.6b's embedding table (622 MB f32).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.convert import key_from_seed
from repro_torch.core import rsvd
from repro_torch.device import resolve_device
from repro_torch.examples import add_common_args
from repro_torch.kernels.ref import dot_f32

RANKS = (16, 32, 64, 128)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.embedding_compression")
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--queries", type=int, default=128)
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # realistic-ish table: cluster structure + zipf-scaled norms
    centers = torch.randn((32, args.dim), generator=gen, device=dev)
    assign = torch.randint(0, 32, (args.vocab,), generator=gen, device=dev)
    table = centers[assign] + 0.3 * torch.randn((args.vocab, args.dim),
                                                generator=gen, device=dev)
    scale = (torch.arange(args.vocab, dtype=torch.float32, device=dev)
             + 2.0) ** -0.3
    table = table * scale[:, None]

    q_ids = torch.randint(0, args.vocab, (args.queries,), generator=gen,
                          device=dev)
    queries = table[q_ids] + 0.05 * torch.randn((args.queries, args.dim),
                                                generator=gen, device=dev)
    true_nn = torch.argmax(dot_f32(queries, table.T), dim=-1)

    full_bytes = table.numel() * 4
    print(f"table ({args.vocab}, {args.dim}) = {full_bytes / 1e6:.1f} MB f32")
    out = {}
    for rank in RANKS:
        res = rsvd.rsvd(key_from_seed(args.seed + 1), table, rank,
                        method="shgemm", device=dev)
        stored = (res.u.numel() + res.s.numel() + res.vt.numel()) * 4
        t_hat = dot_f32(res.u * res.s[None, :], res.vt)
        nn = torch.argmax(dot_f32(queries, t_hat.T), dim=-1)
        agree = float((nn == true_nn).float().mean())
        err = float(rsvd.reconstruction_error(table, res))
        del t_hat
        out[rank] = {"ratio": full_bytes / stored, "rel_err": err,
                     "agreement": agree}
        print(f"  rank {rank:4d}: {full_bytes / stored:5.1f}x smaller  "
              f"rel_err {err:.3f}  top-1 NN agreement {agree * 100:5.1f}%")
    return {"table_bytes": full_bytes, "ranks": out}


if __name__ == "__main__":
    main()
