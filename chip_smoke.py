#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and ``nvcc``.
It imports only ``repro_torch``, torch, numpy and the standard library, and
exits non-zero at the first failed check.  Phases, each printing its lines:

1. setup: the card (``nvidia-smi`` name and power limit), TF32 off, the
   kernel build (``src/repro_torch/kernels/_build/``, one ``nvcc`` per
   source, all started together) and its time;
2. kernels vs their plain PyTorch versions at the main path's shapes
   (rSVD 4096x4096 @ .x266, RP-HOSVD 256x65536 @ .x32): both kernels, the
   on-chip Omega bit check, bit identity across blocks, the f64-oracle
   accuracy ladder;
3. the main path at the paper's sizes (rSVD n=4096 rank 256 on A_exp and
   A_linear, RP-HOSVD and RP-ST-HOSVD on 256^3 with ranks 32^3) through
   every method, with the reference's error limits and the kernels' launch
   counts;
4. timings (median over CUDA events): each kernel beside its plain
   version, the f32 ``torch.matmul`` of the same product (``library_ms``)
   and the least time the card could take (``bound_ms``); end-to-end rSVD
   and RP-HOSVD per method (methods in turns), and a torch.profiler
   breakdown of one call of each.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): device memory rate, bf16/fp16 tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_TC_FLOP_PER_S = 989e12

RSVD_SHAPE = (4096, 4096, 266)     # A (m, k) @ Omega (k, p_hat = 256 + 10)
HOSVD_SHAPE = (256, 65536, 32)     # mode-0 unfolding of 256^3 @ (65536, 32)
REPS = 3
E2E_REPS = 5


class CheckFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def interleaved_host_ms(torch, calls: dict, reps: int) -> dict:
    """Median wall time of each call, ending in a synchronize; the calls run
    in turns (one of each per round, after one warm-up round) so that drift
    of the card or host falls on all of them alike."""
    times = {name: [] for name in calls}
    for rnd in range(reps + 1):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rnd:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: sorted(v)[len(v) // 2] for name, v in times.items()}


def device_breakdown(torch, fn, top: int = 5):
    """One traced call: wall ms, summed device-kernel ms, and the ``top``
    kernels by device time (torch.profiler).  Only device events count:
    an operator's own device time repeats that of its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key[:40], ev.self_device_time_total / 1e3)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(v for _, v in rows), rows[:top]


def bound_ms(m: int, k: int, n: int, terms: int, omega_bytes: int) -> tuple[float, str]:
    """Least time for C = A @ Omega: A read once, Omega read once (0 when
    fused), C written once, over the memory rate; ``terms`` tensor-core
    products over the bf16/fp16 peak.  The larger one, and which it is."""
    t_bytes = (m * k * 4 + omega_bytes + m * n * 4) / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k * terms / PEAK_TC_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def lowp_ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at |x| (normal range)."""
    mant = 7 if dtype == torch.bfloat16 else 10
    tiny = torch.finfo(dtype).tiny
    mag = torch.clamp(x.abs(), min=tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import main_path
    from repro_torch.configs.paper_randnla import PAPER_HOSVD, PAPER_RSVD
    from repro_torch.convert import key_from_seed
    from repro_torch.core import hosvd, projection as proj, rsvd
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2

    dev = torch.device("cuda")
    bf16, fp16 = torch.bfloat16, torch.float16

    # -- 1. setup ---------------------------------------------------------
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[setup] ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)
    key = key_from_seed(7)

    def operand_a(m, k):
        return torch.randn((m, k), generator=gen, device=dev) / math.sqrt(k)

    shapes = {"rsvd": RSVD_SHAPE, "hosvd": HOSVD_SHAPE}
    a_by_shape = {s: operand_a(m, k) for s, (m, k, n) in shapes.items()}
    results = {}

    # -- 2. kernels vs plain versions --------------------------------------
    for sname, (m, k, n) in shapes.items():
        a = a_by_shape[sname]
        b32 = torch.randn((k, n), generator=gen, device=dev)
        for dt in (bf16, fp16):
            b = b32.to(dt)
            for terms in (1, 2, 3):
                if terms == 3 and dt == fp16:
                    continue
                c = ops.shgemm(a, b, terms=terms)
                plain = k1.shgemm_plain(a, b, terms)
                torch.cuda.synchronize()
                err = (c - plain).abs().max().item()
                print(f"[kernels] shgemm {sname} {tuple(a.shape)}@{tuple(b.shape)} "
                      f"{str(dt)[6:]} terms={terms}: max|kernel-plain| {err:.3e}")
                check(torch.allclose(c, plain, rtol=1e-5, atol=1e-4),
                      f"shgemm {sname} {dt} terms={terms} disagrees with plain")
                results[("shgemm", sname, dt, terms)] = err
        bk = ops.heuristic_blocks(m, n, k)[2]
        for dist in k2.SKETCH_DISTS:
            for dt in (bf16, fp16):
                kw = dict(dist=dist, omega_dtype=dt, row_offset=2 * bk,
                          col_offset=7)
                c = ops.shgemm_fused(a, key, n, **kw)
                plain = k2.shgemm_fused_plain(
                    a, key, n, dist=dist, s=k2._resolve_s(dist, None, k),
                    lowp_dtype=dt, row_offset=2 * bk, col_offset=7)
                torch.cuda.synchronize()
                err = (c - plain).abs().max().item()
                print(f"[kernels] shgemm_fused {sname} {tuple(a.shape)} n={n} "
                      f"{dist} {str(dt)[6:]} offsets=({2 * bk},7): "
                      f"max|kernel-plain| {err:.3e}")
                check(torch.allclose(c, plain, rtol=1e-5, atol=1e-4),
                      f"shgemm_fused {sname} {dist} {dt} disagrees with plain")
                results[("shgemm_fused", sname, dt, dist)] = err

    # Omega bit check: with A = I every split and product is exact, so the
    # kernel returns its own on-chip Omega.  HOSVD's 65536 rows are checked
    # on their last 4096 through row_offset.
    for sname, (m, k, n) in shapes.items():
        kk = min(k, 4096)
        eye = torch.eye(kk, device=dev)
        r0 = k - kk
        for dist in k2.SKETCH_DISTS:
            s = k2._resolve_s(dist, None, k)
            for dt in (bf16, fp16):
                got = ops.shgemm_fused(eye, key, n, dist=dist, omega_dtype=dt,
                                       s=s, row_offset=r0, blocks=(128, 64, 256))
                want = k2.reference_omega(key, (kk, n), dist=dist, s=s,
                                          dtype=dt, row_offset=r0,
                                          device=dev).float()
                diff = (got - want).abs()
                nbad = int((diff > 0).sum())
                if dist == "gaussian":
                    ok = bool((diff <= lowp_ulp(torch, want, dt)).all())
                else:
                    ok = nbad == 0
                print(f"[omega] {sname} {dist} {str(dt)[6:]} rows {r0}..{k}: "
                      f"{nbad} of {want.numel()} differ, max {diff.max().item():.3e}")
                check(ok, f"on-chip Omega {sname} {dist} {dt} off the lattice")

    # Bit identity across block shapes that share bk, and fused ==
    # shgemm(fused_omega) at equal blocks for the sparse dists.
    m, k, n = RSVD_SHAPE
    a = a_by_shape["rsvd"]
    omega = proj.fused_omega(key, (k, n), dist="gaussian", device=dev)
    same_bk = [(128, 64, 256), (64, 32, 256), (32, 64, 256)]
    outs = [ops.shgemm(a, omega, blocks=bl) for bl in same_bk]
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "shgemm not bit-identical across blocks sharing bk")
    outs = [ops.shgemm_fused(a, key, n, blocks=bl) for bl in same_bk]
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "shgemm_fused not bit-identical across blocks sharing bk")
    for dist in ("achlioptas", "very_sparse"):
        om = proj.fused_omega(key, (k, n), dist=dist, device=dev)
        check(torch.equal(ops.shgemm_fused(a, key, n, dist=dist, blocks=same_bk[0]),
                          ops.shgemm(a, om, blocks=same_bk[0])),
              f"fused != shgemm(fused_omega) for {dist}")
    print(f"[identity] bit-identical across blocks {same_bk}; "
          f"fused == shgemm(fused_omega) for achlioptas, very_sparse")

    # f64-oracle accuracy ladder (reference DESIGN.md §2).
    b32 = torch.randn((k, n), generator=gen, device=dev)
    for dt in (bf16, fp16):
        b = b32.to(dt)
        oracle = ref.sgemm_f64_oracle(a, b)
        errs = {t: ref.relative_error_fro(ops.shgemm(a, b, terms=t), oracle).item()
                for t in ((1, 2, 3) if dt == bf16 else (1, 2))}
        plain2 = ref.relative_error_fro(k1.shgemm_plain(a, b, 2), oracle).item()
        ef32 = ref.relative_error_fro(ref.dot_f32(a, b), oracle).item()
        print(f"[ladder] {str(dt)[6:]} rel. error vs f64 oracle: "
              + " ".join(f"terms={t} {e:.3e}" for t, e in errs.items())
              + f"; plain 2-term {plain2:.3e}; f32 matmul {ef32:.3e}")
        check(errs[2] < 1e-5, f"{dt} 2-term error {errs[2]} >= 1e-5")
        check(errs[1] > 100 * errs[2], f"{dt} 1-term not lossier than 2-term")
        if dt == bf16:
            check(errs[3] <= 2 * ef32, f"3-term error {errs[3]} > 2x f32 {ef32}")

    # -- 3. main path at paper size ----------------------------------------
    print(f"[main] rsvd n={PAPER_RSVD.n} rank={PAPER_RSVD.rank} "
          f"oversample={PAPER_RSVD.oversample}; hosvd dims={PAPER_HOSVD.dims} "
          f"ranks={PAPER_HOSVD.ranks}; A is {PAPER_RSVD.n ** 2 * 4 / 2**20:.0f} MiB "
          f"and the tensor {math.prod(PAPER_HOSVD.dims) * 4 / 2**20:.0f} MiB")
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    k2.launches = 0
    errors = main_path.run_main_path(PAPER_RSVD, PAPER_HOSVD, device=dev)
    main_launches = {"shgemm": k1.launches, "shgemm_fused": k2.launches}
    for (algo, case, method), e in errors.items():
        print(f"[main] {algo} {case} {method}: rel. error {e:.4e}")
    print(f"[main] launches {main_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    failures = main_path.check_errors(errors)
    check(not failures, "main path errors over the limits: " + "; ".join(failures))
    check(all(v > 0 for v in main_launches.values()),
          f"a kernel of the path was never launched: {main_launches}")

    # -- 4. timings --------------------------------------------------------
    records = {}
    for sname, (m, k, n) in shapes.items():
        a = a_by_shape[sname]
        bm, bn, bk = ops.heuristic_blocks(m, n, k)
        b = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        b_pad = ops._pad_to(b, bk, bn)
        n_pad = b_pad.shape[1]
        omega32 = proj.fused_omega(key, (k, n), device=dev).float()
        b_f32 = b.float()
        rows = {
            "shgemm": (lambda: k1.shgemm_pallas(a, b_pad, bm=bm, bn=bn, bk=bk),
                       lambda: k1.shgemm_plain(a, b, 2),
                       lambda: torch.matmul(a, b_f32), k * n * 2),
            "shgemm_fused": (lambda: k2.shgemm_fused_pallas(a, key, n_pad, bm=bm,
                                                            bn=bn, bk=bk),
                             lambda: k2.shgemm_fused_plain(a, key, n),
                             lambda: torch.matmul(a, omega32), 0),
        }
        for name, (kern, plain, lib, omega_bytes) in rows.items():
            t_k = median_ms(torch, kern)
            t_p = median_ms(torch, plain)
            t_l = median_ms(torch, lib)
            t_b, by = bound_ms(m, k, n, 2, omega_bytes)
            print(f"[time] {name} {sname} ({m}x{k} @ {k}x{n}, bf16, 2 terms, "
                  f"blocks {(bm, bn, bk)}): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                  f"f32 matmul {t_l:.4f} ms, bound {t_b:.4f} ms ({by}); "
                  f"kernel/bound {t_k / t_b:.2f}x [{card}]")
            records[(name, sname)] = (t_k, t_p, t_l, t_b, by)

    a_exp = main_path.rsvd_inputs(PAPER_RSVD, device=dev)["exp"]
    t = main_path.hosvd_input(PAPER_HOSVD, device=dev)
    calls = {("rsvd", m): (lambda m=m: rsvd.rsvd(
        key, a_exp, PAPER_RSVD.rank, oversample=PAPER_RSVD.oversample, method=m))
        for m in main_path.RSVD_METHODS}
    calls.update({(algo, m): (lambda fn=fn, m=m: fn(key, t, PAPER_HOSVD.ranks, method=m))
                  for algo, fn in main_path.HOSVD_ALGOS.items()
                  for m in main_path.HOSVD_METHODS})
    e2e = interleaved_host_ms(torch, calls, E2E_REPS)
    for (algo, method), ms in e2e.items():
        print(f"[e2e] {algo} {method}: {ms:.3f} ms (median of {E2E_REPS}, "
              f"methods interleaved), f32/{method} "
              f"{e2e[(algo, 'f32')] / ms:.3f}x [{card}]")
    omega_ms = interleaved_host_ms(torch, {
        (k, n): (lambda k=k, n=n: proj.materialize_omega(key, (k, n)))
        for k, n in ((RSVD_SHAPE[1], RSVD_SHAPE[2]), (HOSVD_SHAPE[1], HOSVD_SHAPE[2]))},
        E2E_REPS)
    for (k, n), ms in omega_ms.items():
        print(f"[e2e] materialize_omega gaussian ({k}, {n}) bf16, the non-fused "
              f"methods' Omega: {ms:.3f} ms [{card}]")
    for name in (("rsvd", "f32"), ("rsvd", "shgemm_pallas"), ("rsvd", "shgemm_fused"),
                 ("rp_hosvd", "f32"), ("rp_hosvd", "shgemm_pallas"),
                 ("rp_hosvd", "shgemm_fused")):
        wall, busy, top = device_breakdown(torch, calls[name])
        print(f"[profile] {name[0]} {name[1]}: wall {wall:.3f} ms (traced), device "
              f"kernels {busy:.3f} ms (busy {100 * busy / wall:.0f}%); top: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + f" [{card}]")
    per_call = {}
    for name, counter, call in (
            ("rsvd shgemm_pallas", k1, lambda: rsvd.rsvd(
                key, a_exp, PAPER_RSVD.rank, method="shgemm_pallas")),
            ("rsvd shgemm_fused", k2, lambda: rsvd.rsvd(
                key, a_exp, PAPER_RSVD.rank, method="shgemm_fused")),
            ("rp_hosvd shgemm_pallas", k1, lambda: hosvd.rp_hosvd(
                key, t, PAPER_HOSVD.ranks, method="shgemm_pallas")),
            ("rp_hosvd shgemm_fused", k2, lambda: hosvd.rp_hosvd(
                key, t, PAPER_HOSVD.ranks, method="shgemm_fused"))):
        before = counter.launches
        call()
        per_call[name] = counter.launches - before
    print(f"[launches] per call: {per_call}")

    kernels = []
    for name, source, replaces, errkey in (
            ("shgemm", "src/repro_torch/kernels/csrc/shgemm.cu",
             "src/repro/kernels/shgemm.py:46", ("shgemm", "rsvd", bf16, 2)),
            ("shgemm_fused", "src/repro_torch/kernels/csrc/shgemm_fused.cu",
             "src/repro/kernels/shgemm_fused.py:173",
             ("shgemm_fused", "rsvd", bf16, "gaussian"))):
        t_k, t_p, t_l, t_b, by = records[(name, "rsvd")]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": main_launches[name],
                        "max_abs_err": results[errkey], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                        "library_ms": t_l})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
