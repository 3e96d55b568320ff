"""The port's contract checker (counterpart of ``repro/analysis``).

Two engines behind one CLI (``python -m repro_torch.analysis``):

* **Passes over running programs and launches** (`dispatch_passes`,
  `launch_audit`): structural contracts checked on real library entry
  points — GEMM-freeness of structured applies, precision-lowering
  allowlists, keyed randomness and determinism, each under a
  ``TorchDispatchMode``; and the four CUDA kernels' launch grids (no two
  concurrent blocks write one element, every output element is written,
  shared memory within sm_90's limit).
* **AST lint** (`lint`): repo source conventions — atomic artifact IO,
  seeded randomness, monotonic clocks, no host syncs in the decode step's
  code, no f64 in kernels.

The contract catalog lives in `contracts`; accepted findings in
``baseline.json`` beside this package.  ``cli.RULE_DOCS`` lists the rule
ids.
"""

from repro_torch.analysis.dispatch_passes import determinism, dtype_flow, no_gemm
from repro_torch.analysis.findings import Baseline, Finding, load_baseline
from repro_torch.analysis.launch_audit import audit_launches, audit_smem
from repro_torch.analysis.lint import lint_file, lint_paths

__all__ = ["Finding", "Baseline", "load_baseline", "no_gemm", "dtype_flow",
           "determinism", "audit_launches", "audit_smem", "lint_file",
           "lint_paths"]
