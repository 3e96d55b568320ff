"""Quickstart: mixed-precision randomized SVD (the paper in 30 lines).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card ``shgemm_pallas`` launches kernel 1 and ``shgemm_fused``
kernel 2; on the CPU both run their plain versions.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.convert import key_from_seed
from repro_torch.core import rsvd
from repro_torch.device import resolve_device
from repro_torch.examples import add_common_args

METHODS = ("f32", "lowp_single", "shgemm", "shgemm_pallas", "shgemm_fused")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, rank = 1024, 64

    # A test matrix with exponentially decaying spectrum (paper §5.1.1 A_exp)
    s_vals = rsvd.singular_values_exp(n, rank, s_p=1e-4, device=dev)
    a = rsvd.matrix_with_singular_values(gen, n, s_vals)

    print(f"A: {tuple(a.shape)} f32, target rank {rank}")
    residuals = {}
    for method in METHODS:
        res = rsvd.rsvd(key_from_seed(args.seed + 1), a, rank, method=method,
                        device=dev)
        residuals[method] = float(rsvd.reconstruction_error(a, res))
        print(f"  rsvd[{method:>14s}]  rel residual = {residuals[method]:.3e}")

    tail = torch.linalg.norm(s_vals[rank:])
    bound = float(rsvd.halko_bound(tail, rank, 10))
    print(f"  Halko bound (Eq. 4, abs): {bound:.3e}")
    print("note: 'shgemm' stores the random matrix in bf16 and runs the")
    print("      paper's 2-pass split-precision GEMM; 'lowp_single' is the")
    print("      lossy single-pass baseline the paper warns about (Fig. 7);")
    print("      'shgemm_fused' never materializes the random matrix at all")
    print("      (hashed into shared memory inside kernel 2 — zero HBM bytes).")
    return {"residuals": residuals, "halko_bound": bound}


if __name__ == "__main__":
    main()
