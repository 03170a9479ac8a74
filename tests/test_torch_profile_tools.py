"""apex_tpu_torch's three profile tools against the reference's.

- ``tools/timeline.py``: ``account_requests`` and ``account_canary``
  give the reference's summaries (``tools/timeline.py`` imported from
  its path) on the same span dumps — a clean serving run with a shed
  request and a canary deploy window, the same dump with one request's
  terminal event deleted (a broken chain), a TTFT whose components do
  not sum, a canary hop past the window's bound, a wrapped ring — and the
  same dump written by the reference's recorder; ``main`` exits 0 on a
  clean ``--json`` run and on a plain ``--out`` merge of spans, a flight
  dump and a trace window, 1 on a violated ``--json`` run and 2 on an
  unreadable input, as the reference's does.
- ``trace_summary`` and ``step_profile``'s attribution on a
  ``torch.profiler`` window written on the CPU:
  ``step_profile --target resilient --device cpu`` exits 0 with
  fractions summing to 1 and the MFU pin agreeing; ``trace_summary``
  resolves the window, its top ops sum to the attribution's busy time,
  ``--flight`` picks the window a flight dump's steps overlap (exit 1
  when none does), and ``step_profile --hlo`` reads the saved record;
  ``step_profile --target gpt`` on train_gpt's tiny configuration, its
  launch counters empty on the CPU and its cost model counting the
  step's matmuls.
"""

import importlib.util
import json
import os
from pathlib import Path

import pytest

from apex_tpu.observability import spans as jspans
from apex_tpu_torch.observability import FlightRecorder
from apex_tpu_torch.observability import attribution as A
from apex_tpu_torch.observability import spans as pspans
from apex_tpu_torch.tools import step_profile, timeline, trace_summary

ROOT = Path(__file__).resolve().parents[1]


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_timeline():
    return _reference_tool("timeline")


def _serve(rec, *, canary_frac=0.5, over_bound=False):
    """Four requests on a fake clock: three complete (one through the
    canary inside a deploy window), one shed; TTFT components that sum."""
    t = [0.0]

    def at(dt=1.0):
        t[0] += dt
        return t[0]

    rec.begin_deploy_window(at(), canary="r1", frac=canary_frac)
    for rid in range(4):
        to_canary = rid == 1 or (over_bound and rid == 2)
        rec.request_event(rid, "routed", at(),
                          replica="r1" if to_canary else "r0",
                          **({"canary": True} if to_canary else {}))
        rec.request_event(rid, "queued", at())
        if rid == 3:
            rec.request_event(rid, "shed", at(), reason="deadline")
            continue
        rec.request_event(rid, "prefill", at(), ttft_ms=6.0,
                          queue_wait_ms=2.0, prefill_ms=3.0,
                          contention_ms=0.5, cached_prefill_ms=0.5)
        rec.request_event(rid, "decode", at())
        rec.request_event(rid, "done", at())
    rec.end_deploy_window(at(), verdict="pass")


def _dump(module, tmp_path, name="spans.json", **kw):
    rec = module.SpanRecorder(capacity=4096, clock=lambda: 0.0)
    _serve(rec, **kw)
    path = str(tmp_path / name)
    rec.dump(reason="test", path=path)
    with open(path) as f:
        return path, json.load(f)


def _tagged(dump, src=0):
    return [dict(e, _src=src) for e in dump["spans"]]


def _both(ref_timeline, spans, dropped=0, tol=1.0):
    got = (timeline.account_requests(spans, dropped, tol),
           timeline.account_canary(spans))
    ref = (ref_timeline.account_requests(spans, dropped, tol),
           ref_timeline.account_canary(spans))
    assert got == ref
    return got


def test_clean_dump_accounts_as_the_reference(ref_timeline, tmp_path):
    _, dump = _dump(pspans, tmp_path)
    req, can = _both(ref_timeline, _tagged(dump))
    assert req["ok"] and can["ok"], (req, can)
    assert req["requests"] == {"total": 4, "admitted": 3, "complete": 4}
    assert req["shed_reasons"] == {"deadline": 1}
    assert req["ttft_accounting"]["checked"] == 3
    assert can["windows"][0]["canary_routed"] == 1
    assert can["windows"][0]["routed"] == 4


def test_reference_recorder_dump_accounts_the_same(ref_timeline, tmp_path):
    _, port = _dump(pspans, tmp_path, "port.json")
    _, ref = _dump(jspans, tmp_path, "ref.json")
    assert _both(ref_timeline, _tagged(port)) == \
        _both(ref_timeline, _tagged(ref))


def test_broken_chain_fails_as_the_reference(ref_timeline, tmp_path):
    _, dump = _dump(pspans, tmp_path)
    spans = [e for e in _tagged(dump)
             if not (e.get("lane") == 2 and e["name"] == "req/done")]
    req, _ = _both(ref_timeline, spans)
    assert not req["ok"]
    assert any("rid=2" in v and "terminal" in v for v in req["violations"])


def test_ttft_mismatch_and_wrap_fail_as_the_reference(ref_timeline,
                                                      tmp_path):
    _, dump = _dump(pspans, tmp_path)
    spans = _tagged(dump)
    for e in spans:
        if e["name"] == "req/prefill" and e.get("lane") == 0:
            e["args"] = dict(e["args"], ttft_ms=9.0)
    req, _ = _both(ref_timeline, spans)
    assert any("components sum off" in v for v in req["violations"])
    req, _ = _both(ref_timeline, _tagged(dump), dropped={0: 3})
    assert any("dropped" in v for v in req["violations"])


def test_canary_bound_fails_as_the_reference(ref_timeline, tmp_path):
    _, dump = _dump(pspans, tmp_path, canary_frac=0.1, over_bound=True)
    _, can = _both(ref_timeline, _tagged(dump))
    assert not can["ok"]
    assert any("exposure bound" in v for v in can["violations"])


def _flight(tmp_path, steps=range(4)):
    rec = FlightRecorder(capacity=8, directory=str(tmp_path))
    for s in steps:
        rec.on_step(s, skipped=(s == 2))
    return rec.dump("unit test")


def test_timeline_exit_codes(ref_timeline, tmp_path):
    clean, _ = _dump(pspans, tmp_path, "clean.json")
    _, dump = _dump(pspans, tmp_path)
    dump["spans"] = [e for e in dump["spans"]
                     if not (e.get("lane") == 1 and e["name"] == "req/done")]
    broken = str(tmp_path / "broken.json")
    with open(broken, "w") as f:
        json.dump(dump, f)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    flight = _flight(tmp_path)
    window = tmp_path / "trace" / "steps_000001_000002"
    window.mkdir(parents=True)
    (window / "x.pt.trace.json.gz").write_bytes(b"")
    out = str(tmp_path / "merged.json")
    for argv, rc in (
            (["--spans", clean, "--json"], 0),
            (["--spans", broken, "--json"], 1),
            (["--spans", broken, "--out", out], 0),
            (["--spans", bad, "--json"], 2),
            (["--flight", bad], 2),
            (["--spans", clean, "--flight", flight, "--trace-dir",
              str(tmp_path / "trace"), "--out", out, "--json"], 0)):
        assert timeline.main(argv) == rc, argv
        assert ref_timeline.main(argv) == rc, argv
    evs = json.load(open(out))["traceEvents"]
    names = {e.get("name") for e in evs}
    assert {"req/prefill", "train/step", "trace/window"} <= names


@pytest.fixture(scope="module")
def cpu_window(tmp_path_factory):
    """``step_profile --target resilient --device cpu`` into a trace
    window directory; its exit code, JSON report and saved record."""
    tmp = tmp_path_factory.mktemp("profile")
    window = tmp / "trace" / "steps_000002_000004"
    report, record = tmp / "profile.json", tmp / "step.record"
    rc = step_profile.main([
        "--target", "resilient", "--device", "cpu", "--steps", "3",
        "--trace-dir", str(window), "--json", str(report),
        "--hlo-out", str(record), "--metrics-out", str(tmp / "m.jsonl")])
    with open(report) as f:
        return rc, json.load(f), tmp, window, record


def test_step_profile_on_the_cpu(cpu_window):
    rc, report, tmp, window, record = cpu_window
    assert rc == 0
    assert report["target"] == "resilient" and report["steps"] == 3
    assert report["source"] == "host-ops"
    assert abs(report["fraction_sum"] - 1.0) < 1e-6
    assert set(report["fractions"]) == {"compute", "collective",
                                        "host_stall"}
    assert report["mfu"]["agreement"] < 1e-9
    assert report["trace_dir"] == str(window)
    assert os.path.isfile(record)
    lines = [json.loads(x) for x in open(tmp / "m.jsonl")]
    assert {r["metric"] for r in lines} >= {
        "attribution/compute_fraction", "attribution/host_stall_fraction"}
    assert step_profile.main(["--hlo", str(record)]) == 0


def test_trace_summary_reads_the_window(cpu_window, capsys):
    _, _, tmp, window, record = cpu_window
    base = str(tmp / "trace")
    assert trace_summary.resolve_window(base) == str(window)
    trace = trace_summary.load_trace(str(window))
    rows, s = trace_summary.top_ops(trace)
    meas = A.attribute_trace(trace)
    assert s["source"] == meas.source == "host-ops"
    assert rows and abs(sum(r[1] for r in rows) - meas.busy_ms) < 1e-6
    assert trace_summary.main([base, "--attribution", "--hlo",
                               str(record), "-n", "5"]) == 0
    out = capsys.readouterr().out
    assert "attribution (host-ops" in out and "cost model" in out


def test_trace_summary_flight_cross_reference(cpu_window, tmp_path, capsys):
    _, _, tmp, window, _ = cpu_window
    base = str(tmp / "trace")
    inside = _flight(tmp_path / "in", range(1, 4))
    assert trace_summary.cross_reference_flight(base, inside) == str(window)
    assert trace_summary.main([base, "--flight", inside]) == 0
    outside = _flight(tmp_path / "out", range(7, 9))
    assert trace_summary.main([base, "--flight", outside]) == 1
    assert "nothing was profiling" in capsys.readouterr().out


def test_step_profile_gpt_target_on_the_cpu(tmp_path):
    report = tmp_path / "gpt.json"
    rc = step_profile.main([
        "--target", "gpt", "--tiny", "--device", "cpu", "--batch", "2",
        "--seq-len", "32", "--steps", "2", "--trace-dir",
        str(tmp_path / "steps_000002_000003"), "--json", str(report)])
    assert rc == 0
    with open(report) as f:
        rep = json.load(f)
    assert rep["target"] == "gpt" and rep["steps"] == 2
    assert abs(rep["fraction_sum"] - 1.0) < 1e-6
    assert rep["launches"] == {} and rep["kernel_events"] == {}
    assert rep["cost_buckets"]["matmul"]["flops"] > 0
    assert rep["mfu"]["agreement"] < 1e-9
