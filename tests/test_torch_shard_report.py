"""``apex_tpu_torch.tools.shard_report`` against ``tools/shard_report.py``.

- ``render`` is the reference's: for the same report (sections, findings,
  and per program the same collective rows and memory estimate — the
  reference's readers of HLO text stood in for to return them) both print
  the same text, with and without a budget;
- ``--target train --dp 2 --tp 2 --device cpu`` (four gloo ranks) gives
  every parameter the reference's report gives (its compiled step on four
  CPU devices) the reference's declared spec and global bytes, every
  verdict ``ok``, and the reference's JSON keys.  One row is a kept
  divergence: the reference's ``state/opt/count`` is an s32[] on the
  device, the port's step count a host integer, which no device parameter
  holds;
- ``--budget`` under the static peak turns the exit code to 1 (EXCEEDS),
  over it leaves 0 (WITHIN);
- the flags are the reference's less ``--hlo``; the tool refuses without
  a card unless ``--device cpu``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.analysis.findings import Finding
from apex_tpu_torch.tools import shard_report

ROOT = Path(__file__).resolve().parents[1]

SECTIONS = {
    "peak_hbm_bytes": 1582096,
    "shard_plan": [
        {"program": "train3d/dp2tp2/zero", "param": 0,
         "name": "state/params/w1", "shape": "f32[128,256]",
         "global_bytes": 262144, "sharding": "tiled [1,2]",
         "intended": "PartitionSpec(None, 'tp')", "factors": [1, 2],
         "verdict": "ok"},
        {"program": "train3d/dp2tp2/zero", "param": 1,
         "name": "state/params/b2", "shape": "f32[128]",
         "global_bytes": 512, "sharding": "replicated",
         "intended": None, "factors": None, "verdict": "unchecked"},
    ],
}
COLLS = [
    {"kind": "all-reduce", "group_size": 2, "bytes": 65536,
     "dtypes": ["f32"], "op_name": "tp: <step>", "name": "%3"},
    {"kind": "all-gather", "group_size": None, "bytes": 263680,
     "dtypes": [], "op_name": "", "name": "%9"},
]
EST = {"peak_bytes": 1582096, "peak_index": 46,
       "by_category": {"activations": 659212, "optimizer": 395524},
       "buffers": [
           {"name": "param.11", "bytes": 131840, "category": "optimizer",
            "op_name": "state['opt'].m", "defined": 1, "freed": 47},
           {"name": "%40", "bytes": 131072, "category": "activations",
            "op_name": None, "defined": 40, "freed": 47},
           {"name": "%41", "bytes": 512, "category": "activations",
            "op_name": "aten.add", "defined": 41, "freed": 45}]}


def _ref_tool():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_shard_report", ROOT / "tools" / "shard_report.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return mod


@pytest.mark.parametrize("budget", [None, 2 << 20, 1 << 20])
@pytest.mark.parametrize("top", [10, 2])
@pytest.mark.parametrize("with_findings", [False, True])
def test_render_prints_the_references_text(monkeypatch, budget, top,
                                           with_findings):
    from apex_tpu.analysis import findings as jfindings
    from apex_tpu.analysis import hlo as jhlo
    from apex_tpu.analysis import memory as jmem

    ref = _ref_tool()
    monkeypatch.setattr(jhlo, "collective_instructions",
                        lambda text: COLLS if text == "prog-a" else [])
    monkeypatch.setattr(jmem, "estimate_peak", lambda text, top_k=10: dict(
        EST, buffers=EST["buffers"][:top_k]))
    fields = dict(rule="memory-budget", severity="error", path="train",
                  message="over", hint="shrink")
    sides = {}
    for side, finding_cls, programs in (
            ("ref", jfindings.Finding, [("a", "prog-a"), ("b", "")]),
            ("port", Finding, [("a", {"collectives": COLLS,
                                      "memory": EST}), ("b", None)])):
        report = types.SimpleNamespace(
            target="train/dp2tp2/zero", sections=dict(SECTIONS),
            findings=[finding_cls(**fields)] if with_findings else [],
            programs=programs)
        mod = ref if side == "ref" else shard_report
        sides[side] = mod.render(report, top=top, budget=budget)
    assert sides["port"] == sides["ref"]


def test_table_and_bytes_are_the_references():
    ref = _ref_tool()
    rows = [("a", 1, "x"), ("bbbb", 22, "")]
    assert shard_report._table(rows, ("h1", "h2", "h3")) == ref._table(
        rows, ("h1", "h2", "h3"))
    assert shard_report._table([], ("h",)) == ref._table([], ("h",))
    for n in (0, 3, 1023, 1024, 5 << 20, 7 << 30, 1 << 42):
        assert shard_report._fmt_bytes(n) == ref._fmt_bytes(n)


@pytest.fixture(scope="module")
def train_reports(tmp_path_factory):
    """The reference's train report (its analysis's jax.core names moved
    to jax.extend.core under this jax) and the port's, at dp 2 x tp 2."""
    import jax
    import jax.extend.core

    from apex_tpu.analysis import passes as jpasses

    sys.path.insert(0, str(ROOT / "tools"))
    saved = jpasses.jax_core
    jpasses.jax_core = jax.extend.core
    try:
        import graph_lint as gl

        ref_json = gl.lint_train(types.SimpleNamespace(
            dp=2, tp=2, wire="f32", budget=None)).to_json()
    finally:
        jpasses.jax_core = saved
        sys.path.remove(str(ROOT / "tools"))
    path = tmp_path_factory.mktemp("shard_report") / "port.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = shard_report.main(["--target", "train", "--dp", "2", "--tp",
                                "2", "--device", "cpu", "--json", str(path)])
    return ref_json, json.loads(path.read_text()), rc, buf.getvalue()


def test_train_rows_give_the_references_specs_and_bytes(train_reports):
    ref, port, rc, text = train_reports
    assert rc == 0, text
    assert port["target"] == ref["target"] == "train/dp2tp2/zero"
    mine = {r["name"]: r for r in port["shard_plan"]}
    theirs = {r["name"]: r for r in ref["shard_plan"]}
    assert set(theirs) - set(mine) == {"state/opt/count"}
    assert set(mine) <= set(theirs)
    for name, r in mine.items():
        assert (r["intended"], r["global_bytes"]) == (
            theirs[name]["intended"], theirs[name]["global_bytes"]), name
        assert r["factors"] == theirs[name]["factors"], name
        assert r["verdict"] == "ok", r
    assert "findings: none" in text and "== collective schedule" in text


def test_the_ports_zero_step_count_is_a_host_integer():
    from apex_tpu_torch.parallel import distributed_fused_optimizers as dfo

    opt = dfo.DistributedFusedAdam([torch.zeros(4, requires_grad=True)])
    assert type(opt.state.count) is int


def test_json_keys_are_the_references(train_reports):
    ref, port, _, _ = train_reports
    assert sorted(port) == sorted(ref)
    assert sorted(port["shard_plan"][0]) == sorted(ref["shard_plan"][0])


@pytest.mark.parametrize("budget,rc,verdict", [(1024, 1, "EXCEEDS"),
                                               (1 << 30, 0, "WITHIN")])
def test_budget_sets_the_exit_code(budget, rc, verdict):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = shard_report.main(["--target", "resilient", "--device", "cpu",
                                 "--budget", str(budget)])
    text = buf.getvalue()
    assert got == rc, text
    assert f" {verdict} " in text
    assert ("memory-budget" in text) == (rc == 1)


def test_flags_are_the_references_less_hlo(capsys):
    args = shard_report.build_parser().parse_args(["--target", "train"])
    assert (args.dp, args.tp, args.top, args.wire, args.accum, args.budget,
            args.json, args.expect, args.device) == (
        2, 2, 10, "f32", 1, None, None, None, "cuda")
    for dropped in (["--hlo", "x.txt"], ["--donated", "3"]):
        with pytest.raises(SystemExit):
            shard_report.build_parser().parse_args(dropped)
        assert dropped[0] in shard_report.__doc__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_report.main(["--target", "resilient"])
