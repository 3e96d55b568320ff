"""Finding model + baseline for the port's contract checker (the port's
copy of ``repro/analysis/findings.py``: the port imports nothing of
``repro``).

A :class:`Finding` is one violation of a machine-checked repo contract:
a rule id (stable, listed in ``cli.RULE_DOCS``), a ``file:line`` anchor,
a human message, and a fix hint.  Findings come from three engines —
the dispatch-mode passes (``dispatch_passes``), the kernels' launch audit
(``launch_audit``), and the AST lint (``lint``) — and are rendered and
gated uniformly by the CLI.

The baseline (``analysis/baseline.json`` beside this module) suppresses
*accepted* findings: each entry names the rule, the file, a ``match``
string (the stripped source line — line numbers drift, content does not),
and a mandatory justification.  A finding is baselined when (rule, file,
match) all agree; baseline entries that match nothing are reported as
stale so the file cannot rot.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["Finding", "Baseline", "load_baseline", "baseline_doc",
           "split_baselined", "render_text", "render_markdown"]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str              # stable id, e.g. "LINT-ATOMIC-IO"
    file: str              # repo-relative path (or a contract's name)
    line: int              # 1-indexed; 0 when unknown
    message: str           # what is wrong, concretely
    hint: str = ""         # how to fix it
    match: str = ""        # stripped source line, for baseline matching

    def anchor(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file

    def as_record(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "hint": self.hint,
                "match": self.match}


@dataclasses.dataclass
class Baseline:
    """Accepted findings: list of {rule, file, match, reason} entries."""
    entries: list[dict]
    path: Optional[str] = None

    def accepts(self, f: Finding) -> bool:
        return self._entry_for(f) is not None

    def _entry_for(self, f: Finding) -> Optional[dict]:
        for e in self.entries:
            if (e.get("rule") == f.rule and e.get("file") == f.file
                    and e.get("match", "") == f.match):
                return e
        return None

    def stale_entries(self, findings: Iterable[Finding]) -> list[dict]:
        """Entries that matched no finding this run — candidates for
        deletion (the violation was fixed, or the code moved)."""
        used = {id(self._entry_for(f)) for f in findings
                if self._entry_for(f) is not None}
        return [e for e in self.entries if id(e) not in used]


def load_baseline(path: str | Path | None) -> Baseline:
    if path is None:
        return Baseline(entries=[])
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"baseline file {p} does not exist "
                                f"(use --write-baseline to create one)")
    doc = json.loads(p.read_text())
    entries = doc.get("findings", []) if isinstance(doc, dict) else doc
    for e in entries:
        if not e.get("reason"):
            raise ValueError(f"baseline entry {e.get('rule')}/{e.get('file')}"
                             " has no 'reason' — every accepted finding must"
                             " be justified")
    return Baseline(entries=entries, path=str(p))


def baseline_doc(findings: Iterable[Finding]) -> dict:
    """A baseline document accepting every current finding (each entry
    still needs a human-written reason before it passes ``load_baseline``)."""
    return {"version": 1, "findings": [
        {"rule": f.rule, "file": f.file, "match": f.match,
         "reason": "TODO: justify or fix"} for f in findings]}


def split_baselined(findings: list[Finding], baseline: Baseline
                    ) -> tuple[list[Finding], list[Finding]]:
    """-> (new findings that gate, accepted findings suppressed)."""
    new, accepted = [], []
    for f in findings:
        (accepted if baseline.accepts(f) else new).append(f)
    return new, accepted


def render_text(findings: list[Finding], *, accepted: int = 0,
                stale: list[dict] | None = None) -> str:
    lines = []
    by_rule: dict[str, list[Finding]] = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    for rule in sorted(by_rule):
        lines.append(f"[{rule}] {len(by_rule[rule])} finding(s):")
        for f in by_rule[rule]:
            lines.append(f"  {f.anchor()}: {f.message}")
            if f.hint:
                lines.append(f"      hint: {f.hint}")
    lines.append(f"{len(findings)} new finding(s), {accepted} baselined")
    for e in (stale or []):
        lines.append(f"  stale baseline entry: {e.get('rule')} "
                     f"{e.get('file')} ({e.get('reason', '')!r}) — "
                     "matched nothing, consider removing")
    return "\n".join(lines)


def render_markdown(findings: list[Finding], *, accepted: int = 0) -> str:
    """GitHub job-summary rendering (the CLI appends this to
    ``$GITHUB_STEP_SUMMARY`` when it is set)."""
    if not findings:
        return (f"### repro_torch.analysis: clean\n\nNo new findings "
                f"({accepted} baselined).\n")
    out = [f"### repro_torch.analysis: {len(findings)} new finding(s)\n",
           "| rule | where | message | hint |", "|---|---|---|---|"]
    for f in findings:
        msg = f.message.replace("|", "\\|")
        hint = f.hint.replace("|", "\\|")
        out.append(f"| `{f.rule}` | `{f.anchor()}` | {msg} | {hint} |")
    out.append(f"\n{accepted} baselined finding(s) suppressed.\n")
    return "\n".join(out)
