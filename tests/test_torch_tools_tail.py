"""The port's flight_view, concurrency_lint, int8wire_sensitivity and
pipeline_cost tools against the reference's ``tools/`` scripts.

- ``flight_view``: on the same dumps (one written by each package's
  ``FlightRecorder``, with frames, a skip, a rollback, a retry, health
  events, a goodput ledger and a board), the port's render, ``--json``
  summary and ``--timeline`` events equal the reference tool's (imported
  from its path, as ``tests/test_flight.py`` imports it); a file that is
  no dump exits 2 on both.
- ``concurrency_lint``: run as a process with ``torch`` made
  unimportable, it exits 0 over ``apex_tpu_torch/`` with 0 findings and
  ``files_scanned`` equal to the package's source count; on planted
  fixtures (a wall-clock read in a replay-critical module, an unlocked
  counter shared with a thread) it exits 1 with the reference CLI's
  rules, severities, paths and messages.
- ``int8wire_sensitivity.measure``, fed the reference's arrays (its
  ``jax.random`` draws) at the small scale and block 256 on eight gloo
  ranks, gives the reference's one-sync errors within 1e-4 (relative
  errors of ~0.07 and ~0.18), the exact run's final loss within 1e-5
  relative and the loss delta within 2e-5 of the initial loss.
- ``pipeline_cost``: the ideal-bubble model, the header and each row's
  line are the reference's expressions (read from its source with
  ``ast`` and evaluated on the same numbers), and a pp = 2 lockstep
  table at a small size prints the reference's row shapes.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.observability import FlightRecorder as JaxFlightRecorder
from apex_tpu_torch.observability import FlightRecorder
from apex_tpu_torch.tools import flight_view, int8wire_sensitivity
from apex_tpu_torch.tools import pipeline_cost

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# flight_view
# ---------------------------------------------------------------------------


def _dump(recorder_cls, directory):
    rec = recorder_cls(capacity=6, directory=str(directory))
    for s in range(10, 18):
        rec.on_step(s, skipped=(s in (13, 16)))
    rec.on_rollback(16, 12, 1, 0)
    rec.on_retry("checkpoint_save", 1, RuntimeError("io"))
    rec.on_resume(12)
    rec.on_preempt(17)
    return rec.dump("RuntimeError: unit postmortem")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flight")
    return {"jax": _dump(JaxFlightRecorder, tmp / "jax"),
            "port": _dump(FlightRecorder, tmp / "port")}


@pytest.mark.parametrize("which", ["jax", "port"])
@pytest.mark.parametrize("argv", [[], ["--json"], ["-n", "4"]])
def test_flight_view_equals_the_reference(dumps, which, argv, capsys):
    ref = _ref_tool("flight_view")
    path = dumps[which]
    assert ref.main([path, *argv]) == 0
    want = capsys.readouterr().out
    assert flight_view.main([path, *argv]) == 0
    got = capsys.readouterr().out
    assert got == want
    if argv == ["--json"]:
        summary = json.loads(got)
        assert summary["frames"] == 6 and summary["rollbacks"] == 1
        assert summary["retries"] == 1 and summary["preempted"]
    else:
        assert "unit postmortem" in got and "ROLLBACK" in got


def test_flight_view_timeline_equals_the_reference(dumps, tmp_path, capsys):
    ref = _ref_tool("flight_view")
    out = {}
    for side, main in (("jax", ref.main), ("port", flight_view.main)):
        path = tmp_path / f"{side}.trace.json"
        assert main([dumps["port"], "--json", "--timeline", str(path)]) == 0
        capsys.readouterr()
        out[side] = json.loads(path.read_text())
    events = [{k: v for k, v in e.items() if k != "pid"}
              for e in out["port"]["traceEvents"]]
    assert events == [{k: v for k, v in e.items() if k != "pid"}
                      for e in out["jax"]["traceEvents"]]
    assert any(e.get("ph") == "X" for e in events)


def test_flight_view_rejects_a_file_that_is_no_dump(tmp_path, capsys):
    bad = tmp_path / "not_a_dump.json"
    bad.write_text("{}")
    assert flight_view.main([str(bad)]) == 2
    assert _ref_tool("flight_view").main([str(bad)]) == 2
    assert "not a flight dump" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# concurrency_lint
# ---------------------------------------------------------------------------


def _lint(tool, argv, env=None):
    return subprocess.run([sys.executable, *tool, *argv],
                          capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120)


PORT_LINT = ["-m", "apex_tpu_torch.tools.concurrency_lint"]
REF_LINT = [str(TOOLS / "concurrency_lint.py")]


def test_concurrency_lint_is_clean_over_the_port_without_torch(tmp_path):
    out = tmp_path / "clint.json"
    poison = tmp_path / "poison" / "torch"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('torch must not be imported by the lint CLI')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path / 'poison'}:{ROOT}")
    proc = _lint(PORT_LINT, ["--json", str(out)], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    art = json.loads(out.read_text())
    assert art["errors"] == 0 and art["warnings"] == 0
    assert art["findings"] == []
    assert art["rules_run"] == ["concurrency", "purity"]
    assert art["target"] == "apex_tpu_torch"
    sources = list((ROOT / "apex_tpu_torch").rglob("*.py"))
    assert art["files_scanned"] == len(sources) > 150
    # as a script by path too, as the reference CLI runs
    proc = _lint([str(ROOT / "apex_tpu_torch" / "tools" /
                      "concurrency_lint.py")], [], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PLANTED = {
    "serve/bad.py": "import time\n\ndef t():\n    return time.time()\n",
    "goodput/racy.py": textwrap.dedent("""
        import threading


        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(target=self._run)

            def _run(self):
                self.count += 1

            def bump(self):
                self.count += 1
    """),
}


def _findings(art, prefix):
    out = []
    for f in art["findings"]:
        path = f["path"]
        assert path.startswith(prefix), path
        out.append((f["rule"], f["severity"], path[len(prefix):],
                    f["message"].replace(prefix, "")))
    return sorted(out)


def test_concurrency_lint_fails_on_planted_faults_as_the_reference(tmp_path):
    arts = {}
    for side, tool in (("ref", REF_LINT), ("port", PORT_LINT)):
        root = tmp_path / side / "pkg"
        for rel, src in PLANTED.items():
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_text(src)
        out = tmp_path / f"{side}.json"
        proc = _lint(tool, ["--root", str(root), "--json", str(out)],
                     dict(os.environ, PYTHONPATH=str(ROOT)))
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "replay-wall-clock" in proc.stdout
        arts[side] = json.loads(out.read_text())
    port = _findings(arts["port"], "apex_tpu_torch/")
    ref = _findings(arts["ref"], "apex_tpu/")
    assert port == ref
    rules = {f[0] for f in port}
    assert "replay-wall-clock" in rules
    assert rules & {"race-nonatomic-counter", "race-unlocked-shared-state"}
    assert arts["port"]["files_scanned"] == arts["ref"]["files_scanned"] == 2


# ---------------------------------------------------------------------------
# int8wire_sensitivity
# ---------------------------------------------------------------------------


def test_int8wire_measure_equals_the_reference():
    ref = _ref_tool("int8wire_sensitivity")
    assert (int8wire_sensitivity.DP, int8wire_sensitivity.N_STEPS) == (
        ref.DP, ref.N_STEPS) == (8, 30)
    assert int8wire_sensitivity.SCALES == ref.SCALES
    assert int8wire_sensitivity.BLOCKS == ref.BLOCKS
    name = "small (9.5k params)"
    hidden, depth, lr = ref.SCALES[name]
    block = 256
    want = ref.measure(hidden, depth, lr, block)
    # the reference measure's own draws
    key = jax.random.PRNGKey(7)
    xs = jax.random.normal(jax.random.fold_in(key, 1), (ref.DP, 64, 16))
    w_true = jax.random.normal(jax.random.fold_in(key, 2), (16, 1))
    ys = jnp.einsum("rbd,do->rbo", xs, w_true) + 0.01 * jax.random.normal(
        jax.random.fold_in(key, 3), (ref.DP, 64, 1))
    params = jax.tree_util.tree_map(np.asarray,
                                    ref._mlp_init(key, 16, hidden, depth))
    got = int8wire_sensitivity.measure(
        hidden, depth, lr, block,
        inputs=(np.asarray(xs), np.asarray(ys), params), device="cpu")
    m, mx, le, lq, dl = got
    assert abs(m - want[0]) < 1e-4 and abs(mx - want[1]) < 1e-4, (got, want)
    assert abs(le - want[2]) < 1e-5 * want[2], (got, want)
    assert abs(dl - want[4]) < 2e-5, (got, want)
    assert 0.0 < m < mx


def test_int8wire_table_lines_are_the_reference():
    src = (TOOLS / "int8wire_sensitivity.py").read_text()
    tree = ast.parse(src)
    fstrings = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "print" and n.args
                and isinstance(n.args[0], ast.JoinedStr)]
    texts = [ast.unparse(f.args[0]) for f in fstrings]
    header_expr = fstrings[next(i for i, t in enumerate(texts)
                                if "rel_err_mean" in t)].args[0]
    row_expr = fstrings[next(i for i, t in enumerate(texts)
                             if "{name:<22}" in t)].args[0]
    env = dict(name="small (9.5k params)", block=256, m=0.07366,
               mx=0.17917, le=0.694832, lq=0.694957, dl=7e-06)
    assert int8wire_sensitivity.header() == eval(
        compile(ast.Expression(header_expr), "<ref>", "eval"))
    assert int8wire_sensitivity.row_line(**env) == eval(
        compile(ast.Expression(row_expr), "<ref>", "eval"), {}, env)


# ---------------------------------------------------------------------------
# pipeline_cost
# ---------------------------------------------------------------------------


def _ref_main_nodes():
    tree = ast.parse((TOOLS / "pipeline_cost.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    assigns = [n for n in ast.walk(main) if isinstance(n, ast.Assign)]
    prints = [n.args[0] for n in ast.walk(main)
              if isinstance(n, ast.Call) and getattr(n.func, "id", "") ==
              "print" and n.args and isinstance(n.args[0], ast.JoinedStr)]
    return assigns, prints


def _eval(node, env):
    return eval(compile(ast.Expression(node), "<ref>", "eval"), {}, env)


def test_pipeline_cost_model_and_rows_are_the_reference():
    assigns, prints = _ref_main_nodes()
    ideals = [a.value for a in assigns
              if getattr(a.targets[0], "id", "") == "ideal"]
    header = next(a.value for a in assigns
                  if getattr(a.targets[0], "id", "") == "header")
    assert pipeline_cost.HEADER == _eval(header, {})
    assert (pipeline_cost.NM, pipeline_cost.LAYERS, pipeline_cost.HIDDEN) \
        == (8, 8, 512)
    for pp in (2, 4, 8):
        for nm in (1, 8, 32):
            assert pipeline_cost.ideal_speedup(pp, nm) == _eval(
                ideals[0], dict(pp=pp, NM=nm))
            for vpp in (2, 4):
                assert pipeline_cost.ideal_speedup(pp, nm, vpp) == _eval(
                    ideals[1], dict(pp=pp, vpp=vpp, NM=nm))
    lock = next(p for p in prints if "lockstep_1f1b" in ast.unparse(p))
    intl = next(p for p in prints if "'interleaved'" in ast.unparse(p))
    base = next(p for p in prints if "no_pipelining" in ast.unparse(p))
    for remat in (True, False):
        env = dict(pp=2, remat=remat, wall=0.0123, mem=45.6,
                   speed=1.5, ideal=pipeline_cost.ideal_speedup(2, 8))
        row = pipeline_cost.lockstep_row(2, remat, 0.0123, 45.6,
                                         base_wall=1.5 * 0.0123)
        assert row["line"] == _eval(lock, env)
        env.update(vpp=2, ideal=pipeline_cost.ideal_speedup(2, 8, 2))
        row = pipeline_cost.interleaved_row(2, 2, remat, 0.0123, 45.6,
                                            base_wall=1.5 * 0.0123)
        assert row["line"] == _eval(intl, env)
    assert pipeline_cost.baseline_line(0.5, 12.5) == _eval(
        base, dict(LAYERS=8, NM=8, base_wall=0.5, base_mem=12.5))


def test_pipeline_cost_lockstep_table_runs_on_pp_ranks(capsys):
    dims = dict(hidden=32, layers=8, nm=8, mb=2, seq=8)
    rows = pipeline_cost.schedules_table("lockstep", pps=(2,),
                                         device="cpu", dims=dims)
    text = capsys.readouterr().out
    assert [(r["schedule"], r["pp"], r["remat"]) for r in rows] == [
        ("lockstep_1f1b", 2, True), ("lockstep_1f1b", 2, False)]
    for r in rows:
        assert r["wall_ms"] > 0 and np.isnan(r["mem_mb"])  # no CPU stat
        assert r["ideal"] == pipeline_cost.ideal_speedup(2, 8)
        assert r["line"] in text
    assert text.splitlines()[1] == pipeline_cost.HEADER
    assert text.startswith("no_pipelining  (1 rank, L=8, nm=8):")


def test_tools_default_to_the_card():
    for mod in (pipeline_cost, int8wire_sensitivity):
        src = Path(mod.__file__).read_text()
        assert 'ap.add_argument("--device", default="cuda"' in src
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_cost.main(["lockstep"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        int8wire_sensitivity.measure(48, 2, 0.05, 256)
