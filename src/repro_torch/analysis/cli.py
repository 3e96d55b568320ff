"""``python -m repro_torch.analysis`` — run the port's contract checker
(counterpart of ``python -m repro.analysis``).

Default run = AST lint over ``src/repro_torch`` and ``chip_smoke.py`` under
the cwd (the repo root) + the contract catalog, gated by the port's
baseline (``analysis/baseline.json``).  Exit 0 iff no finding survives the
baseline.

    python -m repro_torch.analysis                      # lint + contracts
    python -m repro_torch.analysis src/repro_torch      # explicit lint roots
    python -m repro_torch.analysis --baseline b.json
    python -m repro_torch.analysis --lint-only          # skip the contracts
    python -m repro_torch.analysis --write-baseline b.json   # accept the current set
    python -m repro_torch.analysis --list-rules

Explicit paths are gated by ``--baseline`` alone (none by default), as in
the reference.  When ``$GITHUB_STEP_SUMMARY`` is set, a markdown rendering
of the findings is appended there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from repro_torch._atomic_io import atomic_write_json
from repro_torch.analysis import findings as F

BASELINE = Path(__file__).with_name("baseline.json")
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")

RULE_DOCS = {
    "TORCH-NO-GEMM": "matrix-product operator or kernel launch in a program "
                     "contracted GEMM-free",
    "TORCH-DTYPE-CAST": "float downcast off the precision allowlist",
    "TORCH-F64": "float64 value produced on a labelled path",
    "TORCH-WEAK-PROMOTE": "Python scalar or 0-dim tensor mixes into a "
                          "labelled float path",
    "TORCH-UNKEYED": "randomness not keyed by an entry-point input",
    "TORCH-NONDET": "nondeterministic operator (accumulating float scatter) "
                    "or a rerun with other bits",
    "CUDA-WRITE-ALIAS": "two blocks of one launch write the same element",
    "CUDA-COVERAGE": "an output element no block writes, or a write outside "
                     "a buffer",
    "CUDA-SMEM": "a block's dynamic shared memory above sm_90's 232,448 "
                 "bytes",
    "LINT-ATOMIC-IO": "JSON artifact written without _atomic_io",
    "LINT-NP-RANDOM": "global/unseeded numpy randomness in library code",
    "LINT-WALLCLOCK": "time.time() in library code",
    "LINT-HOST-SYNC": "host read of a device value in the decode step's code",
    "LINT-F64-LITERAL": "float64 literal in a kernel file, double in a CUDA "
                        "kernel source",
    "CONTRACT-ERROR": "a contract failed to run (stale entry point)",
}


def _default_paths() -> list[str]:
    return [p for p in DEFAULT_PATHS if Path(p).exists()]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="dispatch-mode passes, launch audit + repo lint")
    ap.add_argument("paths", nargs="*", help="lint roots (default: "
                    "src/repro_torch and chip_smoke.py under the cwd, gated "
                    "by the port's baseline)")
    ap.add_argument("--baseline", help="accepted-findings JSON; entries "
                    "need a reason")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="write the current finding set as a baseline "
                    "skeleton and exit 0")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the contracts")
    ap.add_argument("--contracts-only", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--contract", action="append", dest="contracts",
                    help="run only the named contract (repeatable)")
    ap.add_argument("--format", choices=("text", "json", "markdown"),
                    default="text")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULE_DOCS.items()):
            print(f"{rule:<18} {doc}")
        return 0

    all_findings: list[F.Finding] = []
    baseline_path = args.baseline

    if not args.contracts_only:
        from repro_torch.analysis.lint import lint_paths
        paths = args.paths
        if not paths:
            paths = _default_paths()
            if baseline_path is None and paths:
                baseline_path = BASELINE
        if not paths:
            print("no lint paths found (run from the repo root or pass "
                  "paths)", file=sys.stderr)
            return 2
        all_findings.extend(lint_paths(paths))

    if not args.lint_only:
        from repro_torch.analysis.contracts import run_repo_contracts
        all_findings.extend(run_repo_contracts(args.contracts))

    if args.write_baseline:
        atomic_write_json(args.write_baseline, F.baseline_doc(all_findings))
        print(f"wrote {len(all_findings)} finding(s) to "
              f"{args.write_baseline}; fill in every 'reason' before "
              "checking it in")
        return 0

    baseline = F.load_baseline(baseline_path)
    new, accepted = F.split_baselined(all_findings, baseline)
    stale = baseline.stale_entries(all_findings) if baseline.entries else []

    if args.format == "json":
        print(json.dumps({
            "new": [f.as_record() for f in new],
            "baselined": [f.as_record() for f in accepted],
            "stale_baseline_entries": stale,
        }, indent=1))
    elif args.format == "markdown":
        print(F.render_markdown(new, accepted=len(accepted)))
    else:
        print(F.render_text(new, accepted=len(accepted), stale=stale))

    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        with open(summary_path, "a") as fh:
            fh.write(F.render_markdown(new, accepted=len(accepted)))

    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
