"""Readings that the limits of ``correct`` are set from, on the card.

    python3 bench/calibrate.py --workload rsvd.fused --seeds 12 --control-seeds 3

For each of ``--seeds`` seeds: the cell's pool, a short closed-loop window of
the program and the same comparison a run makes, its numbers (the largest
over the compared calls) printed.  Then the control on ``--control-seeds``
other seeds: the reference put in the program's place with every product in
TF32 (``reference.matmul_tf32``), compared with the f32 reference the same
way; and once more with the card's own TF32 (``allow_tf32``), as a witness.
One process, so set-up is paid once.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from bench import inputs, reference, run  # noqa: E402


def readings(torch, device, spec, name: str, seed: int, seconds: float,
             call=None) -> dict:
    """One window of ``call`` (the program's entry if None) and its
    comparison; the largest of each number, and the calls made."""
    cell, config, traffic = run.find_cell(spec, name)
    card = run.Card(torch, device)
    call = call or run.program_entry(traffic["entry"], config, traffic, device)
    pool = inputs.make_pool(config, seed, device)
    window = run.run_window(card, call, pool, seed, seconds, traffic["sample"])
    compared = run.compare_sample(torch, traffic["entry"], config, traffic,
                                  pool, window.pop("kept"))
    out = {k: max(c[k] for c in compared) for k in compared[0] if k != "call"}
    out["err_ratio"] = (sum(c["err"] for c in compared)
                        / sum(c["err_ref"] for c in compared))
    out.update(seed=seed, calls=window["calls"], compared=len(compared),
               per_call=compared)
    return out


def _brief(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "per_call"}


def control_call(torch, name: str, spec, hardware_tf32: bool):
    """The reference in the program's place, in TF32: emulated (operands
    rounded, f32 accumulation) or the card's own TF32 GEMMs."""
    _, config, traffic = run.find_cell(spec, name)
    ref = reference.REFERENCES[traffic["entry"]]
    mm = reference.matmul_f32 if hardware_tf32 else reference.matmul_tf32

    def call(key, x):
        torch.backends.cuda.matmul.allow_tf32 = hardware_tf32
        try:
            return ref(x, key, traffic, config, mm)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run._environment()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    read = functools.partial(readings, torch, device, spec, args.workload)
    rows = {"program": [], "control_tf32": [], "control_card_tf32": []}
    for s in range(args.seeds):
        rows["program"].append(read(args.first_seed + s, args.seconds))
        print("program", json.dumps(_brief(rows["program"][-1])), flush=True)
    for s in range(args.control_seeds):
        seed = args.first_seed + 1000 + s
        for label, hw in (("control_tf32", False), ("control_card_tf32", True)):
            call = control_call(torch, args.workload, spec, hw)
            rows[label].append(read(seed, args.seconds, call))
            print(label, json.dumps(_brief(rows[label][-1])), flush=True)
    summary = {label: {k: [r[k] for r in rs] for k in rs[0]
                       if k not in ("seed", "calls", "compared", "per_call")}
               for label, rs in rows.items() if rs}
    summary["card"] = run.card_limit()
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows | {"summary": summary},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
