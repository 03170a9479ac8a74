"""Item 8's first part: the export sinks and ``Reporter``
(``observability/export.py``), the ``Watchdog``'s reporter sink, and the
live memory telemetry (``observability/memstats.py``), each against the
reference module on the same records (the clock pinned, so the bytes
must be equal)."""

from __future__ import annotations

import math
import time

import pytest
import torch

from apex_tpu.observability import export as jexp
from apex_tpu.observability import memstats as jms
from apex_tpu_torch.observability import export, health, memstats
from apex_tpu_torch.observability.flight import FlightRecorder
from apex_tpu_torch.observability.metrics import board

RECORDS = [
    export.bench_record("train/loss", 2.5, "", None, step=1),
    export.bench_record("serve/ttft_ms", 12.25, "ms", None, step=1),
    export.bench_record("train/grad_norm", float("nan"), "", None, step=2),
    export.bench_record("serve/kv_wire", "int8", "", None, step=2),
    export.bench_record("train/mfu", 0.41, "MFU", 0.4, step=3),
    export.bench_record("health/ttft", True, "", None, step=3),
    export.bench_record("train/min", float("inf"), "", None, step=4),
]


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


def _write(mod, sink, records):
    for rec in records:
        sink.write(dict(rec))
    sink.close()


@pytest.mark.parametrize("kind", ["jsonl", "csv", "tensorboard", "timeline"])
def test_sinks_write_the_references_bytes(tmp_path, pinned, kind):
    out = {}
    for name, mod in (("port", export), ("ref", jexp)):
        d = tmp_path / name
        d.mkdir()
        if kind == "jsonl":
            sink, path = mod.JSONLSink(d / "m.jsonl"), d / "m.jsonl"
        elif kind == "csv":
            sink, path = mod.CSVSink(d / "m.csv"), d / "m.csv"
        elif kind == "timeline":
            sink, path = mod.TimelineSink(d / "t.json",
                                          process_name="serve"), d / "t.json"
        else:
            sink = mod.TensorBoardSink(d)
            path = sink.path
            sink.add_scalars(5, {"train/mfu": 0.5, "skip": "x"})
        _write(mod, sink, RECORDS)
        out[name] = open(path, "rb").read()
    assert out["port"] == out["ref"] and out["port"]


def test_bench_record_is_the_references():
    assert export.bench_record("m", 1.0, "ms", None, step=3, host="h") == \
        jexp.bench_record("m", 1.0, "ms", None, step=3, host="h")


def test_flight_entries_are_the_references():
    dump = {"frames": [{"t": 1.0, "step": 1, "metrics": {"loss": 2.0}},
                       {"t": 2.0, "step": 2, "skipped": True,
                        "metrics": {"loss": float("nan")}}],
            "events": [{"t": 1.5, "kind": "retry", "seq": 0}]}
    assert export.flight_entries(dump) == jexp.flight_entries(dump)


class _Meter:
    def summary(self):
        return {"train/step_time_ms": 10.0, "train/mfu": 0.4}


def test_reporter_merges_its_sources(tmp_path):
    board.set("serve/page_size", 16)
    path = tmp_path / "r.jsonl"
    with export.Reporter([export.JSONLSink(path)], meter=_Meter()) as rep:
        values = rep.report(7, extra={"train/loss": 1.5})
    assert values["serve/page_size"] == 16 and values["train/loss"] == 1.5
    import json

    lines = [json.loads(x) for x in path.read_text().splitlines()]
    by = {r["metric"]: r for r in lines}
    assert by["train/step_time_ms"]["unit"] == "ms"
    assert by["train/mfu"]["unit"] == "MFU"
    assert all(r["step"] == 7 for r in lines)


class _Rule(health.Rule):
    name = "planted"
    severity = "warn"

    def evaluate(self, wd, step):
        return [health.HealthEvent(self.name, "warn", step, 2.0, 1.0,
                                   "planted")]


def test_watchdog_writes_events_to_the_reporters_sinks():
    got = []

    class Sink:
        def write(self, rec):
            got.append(rec)

        def close(self):
            pass

    wd = health.Watchdog([_Rule()], reporter=export.Reporter([Sink()]),
                         check_every=1)
    wd.on_step(1)
    assert len(got) == 1
    rec = got[0]
    assert (rec["metric"], rec["value"], rec["step"]) == ("health/planted",
                                                          2.0, 1)
    assert rec["severity"] == "warn" and rec["message"] == "planted"


# ---------------------------------------------------------------------------
# memstats
# ---------------------------------------------------------------------------


def _fakes(**kw):
    return memstats.FakeMemoryProvider(**kw), jms.FakeMemoryProvider(**kw)


@pytest.mark.parametrize("scale", [1.0, 1.2, 2.0, 0.5, 0.7])
def test_crosscheck_gives_the_references_findings(scale):
    static = {"prefill_64": 3.0e9, "decode": 2.5e9}
    mine = memstats.MemStatsMonitor(
        memstats.FakeMemoryProvider.from_static(static, scale=scale))
    ref = jms.MemStatsMonitor(
        jms.FakeMemoryProvider.from_static(static, scale=scale))
    mine.sample(3)
    ref.sample(3)
    got, want = mine.crosscheck(static), ref.crosscheck(static)
    assert got == want
    assert bool(got) == (abs(scale - 1.0) > 0.25)
    if got:
        assert got[0]["program"] == "prefill_64"
        assert got[0]["direction"] == ("static-under-predicts" if scale > 1
                                       else "static-over-predicts")


def test_crosscheck_reads_the_boards_estimates():
    board.set("serve/hbm/prefill_16/peak_hbm_bytes", 1000.0)
    board.set("serve/hbm/decode/peak_hbm_bytes", 800.0)
    board.set("analysis/peak_hbm_bytes", 900.0)
    peaks = memstats.static_peaks_from_board()
    assert peaks["prefill_16"] == 1000.0 and peaks["decode"] == 800.0
    assert peaks["analysis"] == 900.0
    fake, _ = _fakes()
    fake.set_usage(bytes_in_use=2600.0)
    mon = memstats.MemStatsMonitor(fake)
    mon.sample()
    found = mon.crosscheck()
    assert [f["program"] for f in found] == [max(peaks, key=peaks.get)]
    assert board.get("memstats/crosscheck") == 1.0


def test_crosscheck_without_basis_says_so():
    fake, _ = _fakes()
    mon = memstats.MemStatsMonitor(fake)
    assert mon.crosscheck({}) == []
    assert board.get("memstats/crosscheck") == -1.0


def test_rule_events_and_cooldown():
    static = {"decode": 1.0e9}
    fake = memstats.FakeMemoryProvider.from_static(static, scale=2.0)
    rule = memstats.MemStatsRule(memstats.MemStatsMonitor(fake),
                                 static_peaks=static, cooldown=4)
    ref = jms.MemStatsRule(jms.MemStatsMonitor(
        jms.FakeMemoryProvider.from_static(static, scale=2.0)),
        static_peaks=static, cooldown=4)
    ev = rule.check(None, 1)
    ev_ref = ref.check(None, 1)
    assert [(e.rule, e.severity, e.value) for e in ev] == \
        [(e.rule, e.severity, e.value) for e in ev_ref] == \
        [("memstats_drift", "critical", 2.0)]
    assert rule.check(None, 2) == [] and rule.monitor.samples == 2
    assert rule.check(None, 5) != []


def test_oom_forensics_drains_the_history():
    fake, _ = _fakes(limit_bytes=100.0)
    mon = memstats.MemStatsMonitor(fake)
    fake.set_usage(bytes_in_use=40.0)
    mon.sample(1)
    fake.set_usage(bytes_in_use=90.0)
    rec = FlightRecorder()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with memstats.oom_forensics(mon, flight=rec):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    oom = [e for e in rec.events if e["kind"] == "oom"]
    assert len(oom) == 1 and oom[0]["live_peaks"] == {"device0": 90.0}
    assert len(oom[0]["watermarks"]) == 2
    with pytest.raises(KeyError):
        with memstats.oom_forensics(mon, flight=rec):
            raise KeyError("not an oom")
    assert len([e for e in rec.events if e["kind"] == "oom"]) == 1


def test_device_provider_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memstats.DeviceMemoryProvider()
    assert memstats.DeviceMemoryProvider(allow_empty=True).stats() == {}
    assert memstats.default_provider() is None
    with pytest.raises(ValueError, match="needs a provider"):
        memstats.MemStatsMonitor(None)


def test_watermark_gauges():
    fake, _ = _fakes(devices=2, limit_bytes=8.0e9)
    fake.set_usage(device=1, bytes_in_use=3.0e9)
    mon = memstats.MemStatsMonitor(fake)
    mon.sample(9)
    assert board.get("memstats/device1/bytes_in_use") == 3.0e9
    assert board.get("memstats/device0/bytes_limit") == 8.0e9
    assert mon.watermarks()[0]["step"] == 9
    assert math.isclose(mon.live_peaks()["device1"], 3.0e9)
