"""Host time of the kernel wrappers on the card, to compare two checkouts.

    python tools/wrapper_host_us.py [SRC] [--reps 5]

SRC (default: this checkout's ``src``) goes first on ``sys.path``, so one
process measures one checkout; run two checkouts in turns on one card
(A, B, B, A) to compare them.  Each measure is the mean microseconds a call
spends on the host over 1000 calls with no synchronize, the median of
``--reps`` such runs:

* ``fdec``: kernel 4's wrapper at qwen3-0.6b's engine state (8 slots x
  2048, 16 | 8 heads of 128, rank 32, write_pos 222, comp_len 192);
* ``flash``: kernel 3's wrapper at (1, 64, 16 | 8, 128) bf16, causal;
* ``shgemm``: kernel 1's wrapper at 256 x 512 @ 512 x 64;
* ``eager_add``: ``torch.add`` of two 1024-element tensors, the host's own
  speed (the same PyTorch in both checkouts).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 1000


def host_us(torch, fn, reps: int) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="?",
                    default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import shgemm as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b, s, h, kvh, hd, r = 8, 2048, 16, 8, 128, 32
    comp = torch.full((b,), 192, dtype=torch.int32, device=dev)
    pre = (torch.arange(s, device=dev)[None, :] < 192)[..., None, None]
    fdec_args = (rn(b, 1, h, hd, dtype=torch.bfloat16),
                 rn(b, s, kvh, hd).masked_fill(pre, 0).to(torch.bfloat16),
                 rn(b, s, kvh, hd).masked_fill(pre, 0).to(torch.bfloat16),
                 rn(b, kvh, s, r), rn(b, kvh, r, hd), rn(b, kvh, s, r),
                 rn(b, kvh, r, hd), comp)
    q3 = rn(1, 64, h, hd, dtype=torch.bfloat16)
    k3_, v3 = (rn(1, 64, kvh, hd, dtype=torch.bfloat16) for _ in range(2))
    a1, b1 = rn(256, 512), rn(512, 64, dtype=torch.bfloat16)
    x, y = rn(1024), rn(1024)

    out = {
        "fdec": host_us(torch, lambda: k4.factored_decode_attention(
            *fdec_args, 222, scale=hd ** -0.5), args.reps),
        "flash": host_us(torch, lambda: k3.flash_attention(
            q3, k3_, v3, causal=True), args.reps),
        "shgemm": host_us(torch, lambda: k1.shgemm_pallas(
            a1, b1, bm=128, bn=64, bk=256), args.reps),
        "eager_add": host_us(torch, lambda: torch.add(x, y), args.reps),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps({"src": args.src, "host_us": out}))
    return out


if __name__ == "__main__":
    main()
