"""The port's graph passes over a recorded step (``analysis/passes.py``,
``hlo.py``, the checks of ``__init__``) against the reference's rules.

The catalog and the ``Report`` JSON are the reference's; each planted
fault of ``tests/test_analysis.py`` (a host round trip, a silent
promotion, an f64, a dropped donation, a wrong collective count) has a
counterpart that the port's pass catches under the same rule id, and the
clean step gives zero findings.  Every finding the port emits carries a
catalogued id.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from apex_tpu.analysis import findings as jfind
from apex_tpu_torch import analysis
from apex_tpu_torch.analysis import findings, hlo, passes

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the catalog and the report schema
# ---------------------------------------------------------------------------


def test_rule_catalog_is_the_references():
    assert set(findings.RULES) == set(jfind.RULES)
    for rule, (sev, _desc, _hint) in findings.RULES.items():
        assert sev == jfind.RULES[rule][0], rule


@pytest.mark.parametrize("rule", ["transfer-hlo-host", "promotion-widen",
                                  "donation-dropped", "memory-budget",
                                  "collective-count", "kernel-vmem-overflow"])
def test_report_json_is_the_references(rule):
    mine = findings.Report(target="serve/decode", rules_run=("transfer",))
    ref = jfind.Report(target="serve/decode", rules_run=("transfer",))
    mine.extend([findings.make_finding(rule, "op #3", "planted")])
    ref.extend([jfind.make_finding(rule, "op #3", "planted")])
    mine.pass_timings["transfer"] = ref.pass_timings["transfer"] = 1.5
    assert mine.to_json() == ref.to_json()
    assert json.loads(mine.to_json_line()) == json.loads(ref.to_json_line())
    assert mine.ok() == ref.ok()


def _emitted_rule_ids():
    """Every rule id the port's code passes to ``make_finding`` or
    ``Finding`` as a string literal."""
    out = set()
    for path in sorted((ROOT / "apex_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(
                fn, "attr", "")
            first = node.args[0]
            if name in ("make_finding", "Finding", "_finding") and \
                    isinstance(first, ast.Constant) and \
                    isinstance(first.value, str):
                out.add((path.relative_to(ROOT).as_posix(), first.value))
    return out


def test_every_emitted_finding_has_a_catalogued_id():
    emitted = _emitted_rule_ids()
    assert len({r for _, r in emitted}) >= 10
    bad = [(p, r) for p, r in emitted if r not in findings.RULES]
    assert bad == []


def test_trainer_budget_finding_is_memory_budget():
    from apex_tpu_torch.train import demo

    step = demo.build_demo(1, 1, verify="off", device="cpu")
    report = step.verify(hbm_budget=1)
    assert [f.rule for f in report.errors()] == ["memory-budget"]
    mem = report.sections["memory"]
    assert mem["estimate_bytes"] > 0 and mem["peak_bytes"] > 1


# ---------------------------------------------------------------------------
# planted faults (tests/test_analysis.py's, in the port's terms)
# ---------------------------------------------------------------------------


def test_planted_host_read_is_caught():
    """jax.debug.print's counterpart: a device value read on the host."""
    def step(x):
        print(f"loss={x.sum().item()}", end="")
        return x * 2.0

    report = analysis.check(step, torch.zeros(8))
    assert report.rule_ids() == ["transfer-hlo-host"]
    assert not report.ok()


def test_planted_data_dependent_shape_is_caught():
    """pure_callback's counterpart: the host waits for the device."""
    def step(x):
        return x[torch.nonzero(x > 0, as_tuple=True)] + 1.0

    report = analysis.check(step, torch.ones(4), rules=("transfer",))
    assert report.rule_ids() == ["transfer-hlo-host"]


def test_host_read_inside_a_loop_body_is_caught():
    """A read inside a loop fires every iteration: the record is flat."""
    def step(x):
        for _ in range(4):
            x = x + float(x[0])
        return x

    report = analysis.check(step, torch.zeros(4), rules=("transfer",))
    assert len(report.by_rule("transfer-hlo-host")) == 4


def test_planted_silent_promotion_is_caught():
    """bf16 activations meeting a non-scalar f32 tensor widen."""
    def step(x):
        return (x * torch.full((8,), 2.0)).sum()

    report = analysis.check(step, torch.zeros(8, dtype=torch.bfloat16),
                            policy=torch.bfloat16)
    assert report.rule_ids() == ["promotion-widen"]


def test_python_scalar_does_not_flag():
    def step(x):
        return (x * 2.0).sum()

    report = analysis.check(step, torch.zeros(8, dtype=torch.bfloat16),
                            policy=torch.bfloat16)
    assert report.findings == []


def test_named_scope_marks_widening_intentional():
    def step(x):
        with analysis.named_scope("f32_accum"):
            acc = x.float() * 3.0
        return (acc * acc).sum()

    report = analysis.check(step, torch.zeros(8, dtype=torch.bfloat16),
                            policy=torch.bfloat16)
    assert report.findings == []


@pytest.mark.parametrize("form", ["cast", "dtype"])
def test_reduction_upcast_idiom_is_exempt(form):
    def step(x):
        if form == "cast":
            return x.float().sum()
        return torch.sum(x, dtype=torch.float32)

    report = analysis.check(step, torch.zeros(64, dtype=torch.bfloat16),
                            policy=torch.bfloat16)
    assert report.findings == []


def test_planted_f64_is_caught():
    report = analysis.check(lambda x: x * torch.tensor(3.0, dtype=torch.float64),
                            torch.zeros(4, dtype=torch.float64))
    assert report.rule_ids() == ["promotion-f64"]
    assert not report.ok()


def test_planted_dropped_donation_is_caught():
    def step(x, y):
        return x.sum() + y.sum()

    report = analysis.check(step, torch.zeros(64), torch.ones(32),
                            donate_argnums=(0, 1))
    assert report.rule_ids() == ["donation-dropped"]
    assert "2 of 2" in report.by_rule("donation-dropped")[0].message


def test_clean_donation_passes():
    def step(state):
        return {k: v.add_(1.0) for k, v in state.items()}

    state = {"w": torch.zeros(16, 16), "m": torch.zeros(16, 16)}
    report = analysis.check(step, state, donate_argnums=(0,))
    assert report.findings == []
    aliases = dict(hlo.input_output_aliases(report.record))
    assert aliases == {"arg0/m": "in-place", "arg0/w": "in-place"}


def test_copied_state_is_a_dropped_donation():
    """The pool returned as a copy: a fresh buffer of the same size is
    returned and the argument is never written."""
    def step(pool):
        new = pool.clone()
        new[0] = 1.0
        return new

    report = analysis.check(step, torch.zeros(8, 4), donate_argnums=(0,))
    assert report.rule_ids() == ["donation-dropped"]


def _record_with(*collectives):
    ops = [passes.OpRecord(i, kind, "collective", "", (), (),
                           meta={"kind": kind, "axis": "dp", "dtype": dt,
                                 "bytes": nbytes})
           for i, (kind, dt, nbytes) in enumerate(collectives)]
    return passes.StepRecord(ops, {}, {}, (), "cpu")


def test_collective_count_bytes_and_dtype():
    rec = _record_with(("all-reduce", "f32", 64), ("all-reduce", "s8", 16))
    report = analysis.lint_graph(rec, rules=("collective",),
                                 expect_collectives={"all-reduce": 3})
    assert report.rule_ids() == ["collective-count"]
    report = analysis.lint_graph(rec, rules=("collective",), expect_collectives={
        "all-reduce": {"count": 2, "bytes": [0, 70], "dtypes": ["f32"]}})
    assert report.rule_ids() == ["collective-bytes", "collective-dtype"]
    assert hlo.collective_summary(rec) == {"all-reduce": {"count": 2,
                                                          "bytes": 80}}


def test_reshard_pass_holds_the_plan():
    from apex_tpu_torch.train.trainer import check_plan

    rec = _record_with(("all-reduce", "f32", 64), ("all-gather", "bf16", 32))
    plan = {"collectives": [{"kind": "all-reduce", "axis": "dp", "count": 1,
                             "bytes": 64, "dtypes": ["f32"]}],
            "allow_unplanned_bytes": 0}
    report = analysis.lint_graph(rec, rules=("reshard",))
    assert report.findings == []
    graph = analysis.StepGraph(ops=rec, expect_plan=plan)
    found = passes.reshard_pass(graph)
    assert [f.rule for f in found] == ["reshard-plan"]
    assert found == check_plan([op.meta for op in rec.ops], plan)


def test_collectives_of_the_comm_log_are_recorded(monkeypatch):
    from apex_tpu_torch.parallel import comm

    monkeypatch.setattr(comm.ps, "group_axis", lambda group: "tp")

    def step(x):
        comm._record("all-gather", object(), x)
        return x + 1

    report = analysis.check(step, torch.zeros(4),
                            expect_collectives={"all-gather": 1})
    assert report.findings == []
    assert hlo.collective_dtypes(report.record) == {"all-gather": {"f32"}}


def test_clean_step_has_zero_findings():
    def step(w, x):
        h = torch.nn.functional.gelu(x @ w)
        return (h @ w.t()).sum()

    report = analysis.check(step, torch.randn(16, 16), torch.randn(4, 16),
                            policy=torch.float32, hbm_budget=1 << 30,
                            donate_argnums=None, publish=True)
    assert report.findings == []
    assert set(report.rules_run) == {"transfer", "promotion", "donation",
                                     "collective", "reshard", "memory"}
    assert set(report.pass_timings) == set(report.rules_run)
    from apex_tpu_torch.observability.metrics import board

    assert board.get("analysis/errors") == 0


def test_unknown_rule_raises():
    with pytest.raises(ValueError, match="unknown analysis pass"):
        analysis.check(lambda x: x, torch.zeros(1), rules=("bogus",))


def test_lint_package_runs_the_source_passes():
    report = analysis.lint_package()
    assert report.rules_run == ("concurrency", "purity")
    assert report.findings == [] and report.sections["files_scanned"] > 100


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_recorder_maps_views_and_in_place_ops_to_one_buffer():
    def step(x):
        v = x.view(2, 8)[0]
        v.mul_(2.0)
        return x.t() if x.dim() == 2 else x

    _, rec = passes.capture(step, torch.ones(16))
    arg = rec.arguments["arg0"]
    written = {b for op in rec.ops for b in op.writes}
    assert written == {arg}
    assert rec.outputs == (arg,)
    assert all(not op.fresh for op in rec.ops)


def test_recorder_names_scopes_and_parses_like_hlo():
    def step(w, x):
        with analysis.named_scope("mlp"):
            y = x @ w
        return y.relu()

    _, rec = passes.capture(step, torch.ones(8, 4), torch.ones(2, 8))
    comps, entry = hlo.parse_computations(rec)
    instrs = comps[entry]
    mm = [i for i in instrs if i["opcode"].startswith("aten.mm")]
    assert len(mm) == 1 and mm[0]["op_name"].startswith("mlp/")
    assert hlo.instruction_flops(mm[0]) == 2.0 * 2 * 4 * 8
    assert hlo.instruction_bytes(mm[0]) == 4 * (2 * 4 + 8 * 4 + 2 * 8)
    assert instrs[-1]["root"]
    assert hlo.shape_bytes(((8, 128), "bfloat16")) == 2048
    assert hlo.shape_bytes(((8, 128), torch.float32)) == 4096
