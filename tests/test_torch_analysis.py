"""The port's contract checker (src/repro_torch/analysis) on the CPU.

Each engine fires on a seeded violation (tests/torch_analysis_fixtures.py
holds one per rule) and stays silent on the sanctioned pattern; the four
lint rules the packages share give the reference's findings on the same
files; baselines and the CLIs behave alike; the kernels' launch grids are
proven disjoint and covering; and the port itself is clean under its own
baseline.  The card-only half (the NaN-poisoned launches, the contracts on
the card) is in tests/test_torch_cuda.py.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import findings as RF
from repro.analysis.cli import main as ref_cli
from repro.analysis.lint import lint_file as ref_lint_file
from repro.analysis.lint import lint_paths as ref_lint_paths
from repro_torch.analysis import findings as F
from repro_torch.analysis.cli import BASELINE, RULE_DOCS, main as cli_main
from repro_torch.analysis.contracts import CONTRACTS, run_repo_contracts
from repro_torch.analysis.dispatch_passes import (determinism, dtype_flow,
                                                  kernel_launches, no_gemm)
from repro_torch.analysis.launch_audit import (SMEM_LIMIT, audit_launches,
                                               audit_smem, poisoned_launches)
from repro_torch.analysis.lint import CHECKERS, lint_file, lint_paths
from repro_torch.kernels import factored_decode as k4
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import shgemm as k1
from repro_torch.kernels import shgemm_fused as k2
from repro_torch.kernels._grid import Launch, LaunchPlan, Write

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
import torch_analysis_fixtures as fx  # noqa: E402

torch.set_num_threads(2)

_BF16_ALLOW = (("A", "float32", "bfloat16"), ("key", "float32", "bfloat16"))
_KEY = (0x13579BDF, 0x2468ACE0)
SHARED_RULES = ("LINT-ATOMIC-IO", "LINT-NP-RANDOM", "LINT-WALLCLOCK",
                "LINT-F64-LITERAL")
PORT_RULES = {"TORCH-NO-GEMM", "TORCH-DTYPE-CAST", "TORCH-F64",
              "TORCH-WEAK-PROMOTE", "TORCH-UNKEYED", "TORCH-NONDET",
              "CUDA-WRITE-ALIAS", "CUDA-COVERAGE", "CUDA-SMEM",
              "LINT-ATOMIC-IO", "LINT-NP-RANDOM", "LINT-WALLCLOCK",
              "LINT-HOST-SYNC", "LINT-F64-LITERAL"}


def _rules(findings):
    return {f.rule for f in findings}


def _a(*shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(1))


def _host_sync_copy(tmp_path) -> Path:
    """The fixture module under a models/ directory, the rule's scope."""
    dst = tmp_path / "models" / "fixture_step.py"
    dst.parent.mkdir()
    shutil.copy(REPO / "tests" / "torch_analysis_fixtures.py", dst)
    return dst


# ---------------------------------------------------------------------------
# dispatch-mode passes on the seeded fixtures
# ---------------------------------------------------------------------------

class TestNoGemm:
    def test_fires_on_gemm_in_srht_style_apply(self):
        got = no_gemm(fx.bad_srht_apply, _KEY, _a(8, 16), what="fixture srht")
        assert _rules(got) == {"TORCH-NO-GEMM"}
        assert any("aten.mm" in f.message for f in got)
        assert all(f.file == "tests/torch_analysis_fixtures.py" and f.line > 0
                   for f in got)

    def test_clean_on_gemm_free_program(self):
        assert no_gemm(fx.ok_structured_apply, _KEY, _a(8, 16)) == []

    def test_custom_denylist(self):
        got = no_gemm(lambda x: torch.cumsum(x, 0), _a(8), denied=("cumsum",))
        assert _rules(got) == {"TORCH-NO-GEMM"}

    def test_reports_a_kernel_launch_out_of_the_dispatchers_sight(self):
        """Kernels launch through ctypes: the pass reads the wrappers'
        counters, as a CUDA launch would advance them."""
        def launches_kernel_1(x):
            k1.launches += 1
            return x + 1.0
        got = no_gemm(launches_kernel_1, _a(4), what="counted")
        assert _rules(got) == {"TORCH-NO-GEMM"}
        assert "kernel shgemm" in got[0].message
        assert set(kernel_launches()) == {"shgemm", "shgemm_fused",
                                          "flash_attention", "factored_decode"}


class TestDtypeFlow:
    def test_fires_on_f16_cast_on_a_path(self):
        got = dtype_flow(fx.bad_a_downcast, _a(8, 16), _a(16, 4),
                         labels={0: "A", 1: "key"}, allow=_BF16_ALLOW,
                         what="fixture downcast")
        assert _rules(got) == {"TORCH-DTYPE-CAST"}
        # the A->f16 cast is the violation; the key->bf16 cast is allowlisted
        assert len(got) == 1 and "float16" in got[0].message \
            and "[A]" in got[0].message

    def test_copy_into_a_narrower_destination_is_a_cast(self):
        got = dtype_flow(fx.bad_copy_downcast, _a(8), labels={0: "A"},
                         allow=_BF16_ALLOW)
        assert _rules(got) == {"TORCH-DTYPE-CAST"} and "copy_" in got[0].message

    def test_clean_when_cast_is_allowlisted(self):
        assert dtype_flow(lambda a: a.to(torch.bfloat16), _a(8),
                          labels={0: "A"}, allow=_BF16_ALLOW) == []

    def test_unlabelled_cast_needs_the_wildcard(self):
        def const_cast(a):
            return a + torch.ones(8).to(torch.bfloat16).float()
        assert _rules(dtype_flow(const_cast, _a(8), labels={0: "A"},
                                 allow=_BF16_ALLOW)) == {"TORCH-DTYPE-CAST"}
        assert dtype_flow(const_cast, _a(8), labels={0: "A"},
                          allow=_BF16_ALLOW + (("*", "float32", "bfloat16"),)) == []

    def test_fires_on_f64(self):
        got = dtype_flow(fx.bad_f64, _a(8), labels={0: "A"}, allow=_BF16_ALLOW)
        assert _rules(got) == {"TORCH-F64"}

    def test_upcast_never_flagged(self):
        assert dtype_flow(lambda a: a.to(torch.float32),
                          _a(8).to(torch.bfloat16), labels={0: "A"},
                          allow=()) == []

    def test_labels_ride_views_and_in_place_writes(self):
        """A label written into a view reaches its base; a later cast of the
        base is on the labelled path."""
        def through_view(a):
            out = torch.zeros(4, 8)
            out[1:3].copy_(a)
            return out.to(torch.float16)
        got = dtype_flow(through_view, _a(2, 8), labels={0: "A"},
                         allow=_BF16_ALLOW)
        assert [f.message.split("[")[1].split("]")[0] for f in got] == ["A"]

    def test_integer_key_labels_by_value(self):
        """The port's keys are ints: an operator taking a key word carries
        the key's label, so Omega's bf16 rounding is on the key path."""
        def omega(key, n):
            bits = torch.arange(n) + key[0]
            return (bits.float() / 1e9).to(torch.bfloat16)
        assert dtype_flow(omega, _KEY, 8, labels={0: "key"},
                          allow=_BF16_ALLOW) == []
        assert _rules(dtype_flow(omega, _KEY, 8, labels={0: "key"},
                                 allow=())) == {"TORCH-DTYPE-CAST"}

    def test_weak_promotion_reported_only_when_asked(self):
        kw = dict(labels={0: "A", 1: "A"}, allow=_BF16_ALLOW)
        got = dtype_flow(fx.bad_weak_accumulate, _a(4, 4), _a(4, 4),
                         report_weak=True, **kw)
        assert _rules(got) == {"TORCH-WEAK-PROMOTE"}
        assert dtype_flow(fx.bad_weak_accumulate, _a(4, 4), _a(4, 4), **kw) == []
        assert dtype_flow(fx.ok_pinned_accumulate, _a(4, 4), _a(4, 4),
                          report_weak=True, **kw) == []


class TestDeterminism:
    def test_fires_on_unkeyed_randomness(self):
        got = determinism(fx.bad_unkeyed, _a(8), what="fixture unkeyed")
        assert _rules(got) == {"TORCH-UNKEYED"}

    def test_clean_on_caller_keyed_randomness(self):
        assert determinism(fx.ok_keyed, _KEY, _a(8), key_arg=0) == []

    def test_fires_when_the_key_reaches_no_draw(self):
        got = determinism(fx.bad_key_ignored, _KEY, _a(8), key_arg=0)
        assert _rules(got) == {"TORCH-UNKEYED"}
        assert "same output under two keys" in got[0].message

    def test_fires_on_accumulating_float_scatter(self):
        idx = torch.tensor([0, 0, 1])
        assert _rules(determinism(fx.bad_scatter_add, _a(3), idx)) == \
            {"TORCH-NONDET"}
        # an integer scatter adds exactly: no finding
        assert determinism(lambda i: torch.zeros(4, dtype=torch.int64)
                           .index_add_(0, i, torch.ones(3, dtype=torch.int64)),
                           idx) == []

    def test_fires_when_a_rerun_gives_other_bits(self):
        calls = []

        def drifts(x):
            calls.append(1)
            return x + len(calls)
        got = determinism(drifts, _a(4))
        assert _rules(got) == {"TORCH-NONDET"} and "other bits" in got[0].message


# ---------------------------------------------------------------------------
# launch audit
# ---------------------------------------------------------------------------

class TestLaunchAudit:
    def test_fires_on_an_overlapping_grid(self):
        assert "CUDA-WRITE-ALIAS" in _rules(audit_launches(fx.bad_alias_grid()))

    def test_fires_on_an_uncovered_tile(self):
        got = audit_launches(fx.bad_uncovered_grid())
        assert _rules(got) == {"CUDA-COVERAGE"} and "128 of 256" in got[0].message

    def test_clean_on_disjoint_covering_tiles(self):
        assert audit_launches(fx.ok_tiled_grid()) == []

    def test_fires_on_a_write_outside_the_buffer(self):
        plan = LaunchPlan((Launch("k", (1,), lambda idx: [
            Write("out", (slice(0, 20),))]),), {"out": (16,)}, ())
        assert _rules(audit_launches(plan)) == {"CUDA-COVERAGE"}

    def test_a_ticket_is_one_writer(self):
        """Kernel 4's merge: blocks sharing a row's ticket write its output
        once between them."""
        plan = LaunchPlan((Launch("k", (4, 2), lambda idx: [
            Write("out", (idx[1],), ticket=idx[1])]),), {"out": (2,)},
            ("out",))
        assert audit_launches(plan) == []

    def test_smem_over_the_limit(self):
        assert SMEM_LIMIT == 232448
        assert _rules(audit_smem(fx.BAD_SMEM)) == {"CUDA-SMEM"}
        assert audit_smem([("fits", SMEM_LIMIT)]) == []

    @pytest.mark.parametrize("tile", k1.TILES, ids=str)
    def test_gemm_grids_are_the_launch_lines(self, tile):
        """Kernels 1 and 2 launch (N / BN, M / BM, splits) blocks (and the
        reduction with splits), disjoint and covering, at every tile."""
        bm, bn = tile
        m, n, k, bk = 3 * bm, 2 * bn, 512, 64
        for splits in (1, 2, 8):
            for mod in (k1, k2):
                plan = mod.launch_grid(m, n, k, bm, bn, bk, splits)
                assert plan.launches[0].grid == (n // bn, m // bm, splits)
                assert len(plan.launches) == (1 if splits == 1 else 2)
                assert audit_launches(plan) == []

    @pytest.mark.parametrize("g", k3.GROUPS)
    def test_flash_grid_covers_every_group_size(self, g):
        for causal in (True, False):
            plan = k3.launch_grid(2, 77, 3 * g, 3, 32, causal=causal)
            bq = k3.query_rows(g)
            assert plan.launches[0].grid == (-(-77 // bq), 6)
            assert audit_launches(plan) == []

    def test_decode_grid_writes_workspace_by_share(self):
        """Empty shares write m and l only, compressed slots acc_f too, and
        one ticketed block a row writes the output."""
        plan = k4.decode_plan(2, 2, 256, 8, 4, 2, splits=8)
        lp = k4.launch_grid(2, 2, 8, 4, 2, plan, 20, [16, 0])
        assert lp.launches[0].grid == (8, 4)
        assert audit_launches(lp) == []
        empty = lp.launches[0].writes((7, 0))     # share 7 of 8 at clock 20
        assert [w.region[-1] for w in empty[:-1]] == [slice(0, 2)]
        full = lp.launches[0].writes((0, 0))
        assert [w.region[-1] for w in full[:-1]] == [slice(0, 2), slice(2, 10),
                                                     slice(10, 14)]
        assert [w.region[-1] for w in lp.launches[0].writes((0, 2))[:-1]] == \
            [slice(0, 2), slice(2, 10)]           # slot 1: no prefix

    def test_wrappers_fill_a_given_out(self):
        """``out=`` (the NaN-poisoned launches' buffers) is written in place;
        on the CPU the plain versions run and the workspace stays unused."""
        res = poisoned_launches("cpu")
        assert set(res) == {"shgemm", "shgemm_fused", "flash_attention",
                            "factored_decode"}
        for r in res.values():
            assert r["nan_out"] == 0 and r["bitwise"] and r["into_out"]
            assert r["launches"] == 0
        with pytest.raises(ValueError, match="out must be"):
            k1.shgemm_pallas(_a(32, 32), _a(32, 32).to(torch.bfloat16), bm=32,
                             bn=32, bk=32, out=torch.empty(32, 16))


# ---------------------------------------------------------------------------
# AST lint on the seeded fixtures
# ---------------------------------------------------------------------------

class TestLint:
    def test_fixture_module_exact_rule_ids(self):
        got = lint_file(REPO / "tests" / "torch_analysis_fixtures.py")
        assert _rules(got) == {"LINT-ATOMIC-IO", "LINT-NP-RANDOM",
                               "LINT-WALLCLOCK"}

    def test_host_sync_fires_on_its_fixture_only(self, tmp_path):
        """Under models/: bool(mask.any()), int(write_pos), .item(), an
        element indexed by a shape and a getter's result of the bad step;
        len(), round(), literals, shapes, sizes and config attributes of
        the sanctioned one stay silent."""
        path = _host_sync_copy(tmp_path)
        got = lint_file(path, checkers=("LINT-HOST-SYNC",))
        src = path.read_text().splitlines()
        bad = [i + 1 for i, s in enumerate(src) if "def bad_host_sync" in s][0]
        ok = [i + 1 for i, s in enumerate(src) if "def ok_host_values" in s][0]
        assert sorted(f.line for f in got) == [bad + 1, bad + 2, bad + 2,
                                               bad + 3, bad + 4]
        assert not any(ok <= f.line for f in got)
        # outside models/ the rule does not apply
        assert lint_file(REPO / "tests" / "torch_analysis_fixtures.py",
                         checkers=("LINT-HOST-SYNC",)) == []

    def test_f64_fixture_fires_only_in_kernel_scope(self):
        kernel_fixture = REPO / "tests" / "kernels" / "fixture_f64.py"
        assert _rules(lint_file(kernel_fixture)) == {"LINT-F64-LITERAL"}
        outside = lint_file(REPO / "tests" / "torch_analysis_fixtures.py",
                            checkers=("LINT-F64-LITERAL",))
        assert outside == []

    def test_double_token_in_a_cuda_kernel_source(self, tmp_path):
        src = tmp_path / "kernels" / "csrc" / "k.cu"
        src.parent.mkdir(parents=True)
        src.write_text('// double in a comment\n'
                       'const char* s = "double";\n'
                       '/* a double\n   in a block */ float x;\n'
                       '__device__ double acc;\n')
        got = lint_paths([tmp_path / "kernels"])
        assert [(f.rule, f.line) for f in got] == [("LINT-F64-LITERAL", 5)]
        other = tmp_path / "notkernels.cu"
        other.write_text("double x;\n")
        assert lint_file(other) == []

    def test_findings_carry_anchor_and_hint(self, tmp_path):
        for path in (REPO / "tests" / "torch_analysis_fixtures.py",
                     _host_sync_copy(tmp_path)):
            got = lint_file(path)
            assert got
            for f in got:
                assert f.line > 0 and f.match and f.hint

    def test_atomic_io_module_itself_exempt(self):
        got = lint_file(REPO / "src" / "repro_torch" / "_atomic_io.py",
                        checkers=("LINT-ATOMIC-IO",))
        assert got == []

    def test_torch_generator_not_flagged_as_np_random(self, tmp_path):
        p = tmp_path / "ok.py"
        p.write_text("import torch\n\n"
                     "def f(gen, n):\n"
                     "    return torch.rand(n, generator=gen)\n")
        assert lint_file(p) == []

    def test_every_lint_rule_documented(self):
        for rule in CHECKERS:
            assert rule in RULE_DOCS
        assert PORT_RULES <= set(RULE_DOCS)


# ---------------------------------------------------------------------------
# parity with the reference's lint, baseline and CLI
# ---------------------------------------------------------------------------

def _shared(findings):
    return {(f.rule, f.file, f.line, f.match) for f in findings
            if f.rule in SHARED_RULES}


@pytest.mark.parametrize("target", [
    "tests/fixture_analysis_violations.py", "tests/kernels/fixture_f64.py",
    "src/repro", "src/repro_torch"])
def test_lint_parity_with_reference(target, monkeypatch):
    """The four rules both packages have give the same (rule, file, line,
    match) set on the reference's fixtures and on both trees."""
    monkeypatch.chdir(REPO)
    port = _shared(lint_paths([target]))
    ref = _shared(ref_lint_paths([target]))
    assert port == ref
    if target != "src/repro":
        assert port  # each target holds at least one shared finding


def test_lint_parity_on_a_single_file(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import json, time\nimport numpy as np\n\n"
                   "def f(p, d):\n"
                   "    t0 = time.time()\n"
                   "    with open('out.json', 'w') as fh:\n"
                   "        json.dump(d, fh)\n"
                   "    return np.random.default_rng(), time.time() - t0\n")
    assert _shared(lint_file(bad)) == _shared(ref_lint_file(bad))
    assert len(_shared(lint_file(bad))) == 5


class TestBaselineParity:
    def _finding(self, mod):
        return mod.Finding(rule="LINT-WALLCLOCK", file="src/x.py", line=3,
                           message="m", hint="h", match="t0 = time.time()")

    def test_entry_without_reason_rejected_by_both(self, tmp_path):
        p = tmp_path / "b.json"
        p.write_text(json.dumps({"findings": [
            {"rule": "LINT-WALLCLOCK", "file": "src/x.py",
             "match": "t0 = time.time()"}]}))
        for mod in (F, RF):
            with pytest.raises(ValueError, match="reason"):
                mod.load_baseline(p)

    def test_same_json_same_splits(self, tmp_path):
        doc = F.baseline_doc([self._finding(F)])
        assert doc == RF.baseline_doc([self._finding(RF)])
        doc["findings"][0]["reason"] = "startup timestamp, not a duration"
        doc["findings"].append({"rule": "LINT-WALLCLOCK", "file": "gone.py",
                                "match": "x", "reason": "fixed long ago"})
        p = tmp_path / "b.json"
        p.write_text(json.dumps(doc))
        other = {"rule": "LINT-NP-RANDOM", "file": "src/y.py", "line": 1,
                 "message": "m", "hint": "h", "match": "np.random.rand(3)"}
        out = []
        for mod in (F, RF):
            base = mod.load_baseline(p)
            fs = [self._finding(mod), mod.Finding(**other)]
            new, accepted = mod.split_baselined(fs, base)
            out.append(([f.as_record() for f in new],
                        [f.as_record() for f in accepted],
                        base.stale_entries(fs)))
        assert out[0] == out[1]
        assert len(out[0][0]) == 1 and len(out[0][1]) == 1 and len(out[0][2]) == 1

    def test_match_is_line_number_drift_proof(self, tmp_path):
        doc = F.baseline_doc([self._finding(F)])
        doc["findings"][0]["reason"] = "r"
        p = tmp_path / "b.json"
        p.write_text(json.dumps(doc))
        drifted = F.Finding(rule="LINT-WALLCLOCK", file="src/x.py", line=99,
                            message="m", match="t0 = time.time()")
        assert F.split_baselined([drifted], F.load_baseline(p))[0] == []

    def test_missing_baseline_file_raises(self, tmp_path):
        for mod in (F, RF):
            with pytest.raises(FileNotFoundError):
                mod.load_baseline(tmp_path / "nope.json")


class TestCliParity:
    @pytest.fixture(autouse=True)
    def _no_ci_summary(self, monkeypatch):
        monkeypatch.delenv("GITHUB_STEP_SUMMARY", raising=False)

    def _bad_file(self, tmp_path):
        p = tmp_path / "bad.py"
        p.write_text("import time\n\n"
                     "def f():\n"
                     "    return time.time()\n")
        return p

    def test_same_exit_code_and_json_records(self, tmp_path, capsys):
        bad = str(self._bad_file(tmp_path))
        docs = []
        for main in (cli_main, ref_cli):
            assert main([bad, "--lint-only", "--format", "json"]) == 1
            docs.append(json.loads(capsys.readouterr().out))
        assert docs[0] == docs[1]
        assert docs[0]["new"][0]["rule"] == "LINT-WALLCLOCK"

    def test_baseline_gates_both_to_exit_0(self, tmp_path, capsys):
        bad = str(self._bad_file(tmp_path))
        b = tmp_path / "baseline.json"
        assert cli_main([bad, "--lint-only", "--write-baseline", str(b)]) == 0
        doc = json.loads(b.read_text())
        assert doc["findings"] and all(e["reason"] for e in doc["findings"])
        capsys.readouterr()
        for main in (cli_main, ref_cli):
            assert main([bad, "--lint-only", "--baseline", str(b)]) == 0
            assert "0 new finding(s), 1 baselined" in capsys.readouterr().out

    def test_list_rules(self, capsys):
        assert cli_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in RULE_DOCS:
            assert rule in out

    def test_markdown_format_and_step_summary(self, tmp_path, monkeypatch,
                                              capsys):
        summary = tmp_path / "summary.md"
        monkeypatch.setenv("GITHUB_STEP_SUMMARY", str(summary))
        assert cli_main([str(self._bad_file(tmp_path)), "--lint-only",
                         "--format", "markdown"]) == 1
        assert "| `LINT-WALLCLOCK` |" in capsys.readouterr().out
        assert "repro_torch.analysis" in summary.read_text()


# ---------------------------------------------------------------------------
# acceptance: the seeded fixture set produces exactly the port's rule ids
# ---------------------------------------------------------------------------

def test_fixture_violations_produce_the_ports_rule_set(tmp_path):
    findings = []
    findings += no_gemm(fx.bad_srht_apply, _KEY, _a(8, 16), what="fx")
    findings += dtype_flow(fx.bad_a_downcast, _a(8, 16), _a(16, 4),
                           labels={0: "A", 1: "key"}, allow=_BF16_ALLOW)
    findings += dtype_flow(fx.bad_f64, _a(8), labels={0: "A"})
    findings += dtype_flow(fx.bad_weak_accumulate, _a(4, 4), _a(4, 4),
                           labels={0: "A", 1: "A"}, report_weak=True)
    findings += determinism(fx.bad_unkeyed, _a(8))
    findings += determinism(fx.bad_scatter_add, _a(3), torch.tensor([0, 0, 1]))
    findings += audit_launches(fx.bad_alias_grid())
    findings += audit_launches(fx.bad_uncovered_grid())
    findings += audit_smem(fx.BAD_SMEM)
    findings += lint_file(REPO / "tests" / "torch_analysis_fixtures.py")
    findings += lint_file(_host_sync_copy(tmp_path))
    findings += lint_file(REPO / "tests" / "kernels" / "fixture_f64.py")
    assert _rules(findings) == PORT_RULES


# ---------------------------------------------------------------------------
# the port is clean under its checked-in baseline
# ---------------------------------------------------------------------------

def test_port_lint_clean_under_baseline(monkeypatch):
    monkeypatch.chdir(REPO)
    findings = lint_paths(["src/repro_torch", "chip_smoke.py"])
    baseline = F.load_baseline(BASELINE)
    new, _ = F.split_baselined(findings, baseline)
    assert new == [], F.render_text(new)
    assert baseline.stale_entries(findings) == []
    assert not [f for f in findings if f.file == "chip_smoke.py"]


def test_baseline_holds_the_write_position_reads():
    """The six int(write_pos) sites, each with the reason naming ROADMAP's
    recorded item 4, and the reference's five entries carried over."""
    entries = json.loads(BASELINE.read_text())["findings"]
    reason = ("host read of the write position; blocks CUDA-graph capture "
              "(ROADMAP recorded item 4)")
    sync = [e for e in entries if e["reason"] == reason]
    assert len(sync) == 6 and all(e["rule"] == "LINT-HOST-SYNC"
                                  and "int(write_pos)" in e["match"] for e in sync)
    ref = json.loads((REPO / "analysis_baseline.json").read_text())["findings"]
    carried = {(e["rule"], e["file"].split("/", 2)[-1], e["reason"])
               for e in entries}
    assert all((e["rule"], e["file"].split("/", 2)[-1], e["reason"]) in carried
               for e in ref)


def test_contract_catalog_names_are_stable():
    assert set(CONTRACTS) == {
        "srht-no-gemm", "sketch-dtype-flow", "stream-update-dtype-flow",
        "sketch-determinism", "shgemm-fused-audit", "factored-decode-audit",
        "stream-b-weak-audit", "shgemm-audit", "flash-attention-audit",
    }


def test_repo_contract_catalog_clean():
    findings = run_repo_contracts()
    assert findings == [], F.render_text(findings)


def test_contract_error_is_a_finding(monkeypatch):
    def broken(device):
        raise TypeError("entry point moved")
    monkeypatch.setitem(CONTRACTS, "srht-no-gemm", broken)
    got = run_repo_contracts(["srht-no-gemm"])
    assert _rules(got) == {"CONTRACT-ERROR"} and "entry point moved" in got[0].message


def test_cli_default_run_exits_0():
    """``python -m repro_torch.analysis`` from the repo root: the lint of
    the port and chip_smoke.py plus the catalog, under the port's
    baseline, with no new and no stale finding."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new finding(s)" in out.stdout and "stale" not in out.stdout
