"""Structured metric export — one ``report()`` API, three sinks.

Counterpart of ``apex_tpu/observability/export.py``, byte for byte in
what it writes.  Every record is the reference's ``bench.py`` metric-line
schema::

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

plus a ``"step"`` key on telemetry lines, so a live ``--metrics-out``
JSONL and the ``BENCH_*.json`` trajectory artifacts are the same
language — a regression is a diff between two JSONL files, not prose.

Sinks:

- :class:`JSONLSink` — one JSON object per line (the canonical form);
- :class:`CSVSink` — spreadsheet-friendly, columns fixed by the first
  record;
- :class:`TensorBoardSink` — real ``events.out.tfevents.*`` scalar
  files, written directly (TFRecord framing + masked CRC32C + a
  hand-encoded ``Event`` proto), because this environment must not grow
  a tensorboard/tensorflow dependency.  Any TensorBoard install reads
  the output.

:class:`Reporter` fans one step's values out to every sink, pulling
from the attached sources (:class:`~apex_tpu_torch.observability.metrics.
MetricRegistry`, :class:`~apex_tpu_torch.observability.meter.StepMeter`,
:class:`~apex_tpu_torch.observability.meter.GoodputAccountant`, and the
module :data:`~apex_tpu_torch.observability.metrics.board`).
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
from typing import Any, Dict, IO, Iterable, Mapping, Optional, Union

__all__ = [
    "bench_record",
    "JSONLSink",
    "CSVSink",
    "TensorBoardSink",
    "TimelineSink",
    "flight_entries",
    "flight_counters",
    "Reporter",
]


def bench_record(
    metric: str,
    value,
    unit: str = "",
    vs_baseline=None,
    **extra,
) -> Dict[str, Any]:
    """A record in the bench.py line schema; ``extra`` keys (``step``,
    ...) append after the four contract keys."""
    rec: Dict[str, Any] = {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": vs_baseline,
    }
    rec.update(extra)
    return rec


class _FileSink:
    """Shared open/close plumbing: path or open file object."""

    def __init__(self, target: Union[str, os.PathLike, IO], mode: str = "a"):
        if hasattr(target, "write"):
            self._f, self._owns = target, False
        else:
            path = os.fspath(target)
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._f, self._owns = open(path, mode), True

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JSONLSink(_FileSink):
    """One JSON object per line, flushed per write (a killed run keeps
    every completed line — the property resume debugging relies on).

    Opens in APPEND mode deliberately: a preempted job relaunched on
    the same ``--metrics-out`` path continues its telemetry stream the
    way its checkpoints continue training (and the ``BENCH_all_*``
    artifacts accrete lines the same way).  Consumers wanting "this
    run only" should take the last matching record.

    Non-finite floats (a NaN grad norm on a skipped step, an untouched
    min/max seed at ±inf) are written as JSON ``null`` — bare ``NaN``
    is invalid JSON that jq/JS parsers reject wholesale, and in the
    bench schema null already means "no measurement"."""

    def write(self, record: Mapping[str, Any]) -> None:
        clean = {
            k: (None if isinstance(v, float) and (v != v or v in (
                float("inf"), float("-inf"))) else v)
            for k, v in record.items()
        }
        self._f.write(json.dumps(clean, allow_nan=False) + "\n")
        self._f.flush()


class CSVSink(_FileSink):
    """Columns are the FIRST record's keys; later extras are dropped
    and missing keys left blank (csv needs a stable header).

    Unlike :class:`JSONLSink` this TRUNCATES an existing path: a CSV
    cannot tolerate a second header row mid-file or a column set fixed
    by some earlier run's first record."""

    def __init__(self, target):
        super().__init__(target, mode="w")
        self._writer: Optional[csv.DictWriter] = None

    def write(self, record: Mapping[str, Any]) -> None:
        if self._writer is None:
            self._writer = csv.DictWriter(
                self._f, fieldnames=list(record), extrasaction="ignore"
            )
            self._writer.writeheader()
        self._writer.writerow(
            {k: record.get(k, "") for k in self._writer.fieldnames}
        )
        self._f.flush()


# -- TensorBoard event encoding (no tensorflow/tensorboard dependency) ------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) — the TFRecord checksum.  Table built once;
    called only on the report cadence, so pure Python is fine."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _pb_varint_tag(field, 2) + _pb_varint(len(payload)) + payload


def _pb_varint_tag(field: int, wire: int) -> bytes:
    return _pb_varint(field << 3 | wire)


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _event_proto(
    wall_time: float, step: int, scalars: Mapping[str, float] = (),
    file_version: Optional[str] = None,
) -> bytes:
    # Event{1: double wall_time, 2: int64 step, 3: string file_version,
    #       5: Summary{repeated 1: Value{1: string tag,
    #                                    2: float simple_value}}}
    ev = _pb_varint_tag(1, 1) + struct.pack("<d", wall_time)
    ev += _pb_varint_tag(2, 0) + _pb_varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            val = _pb_bytes(1, tag.encode())
            val += _pb_varint_tag(2, 5) + struct.pack("<f", float(value))
            summary += _pb_bytes(1, val)
        ev += _pb_bytes(5, summary)
    return ev


class TensorBoardSink:
    """Scalar summaries into ``logdir/events.out.tfevents.<ts>.<pid>``.

    ``write`` takes a bench-schema record: non-numeric values are
    skipped (TensorBoard scalars are floats), the ``step`` key (default
    0) becomes the global step, and the metric name becomes the tag.
    """

    def __init__(self, logdir: Union[str, os.PathLike]):
        os.makedirs(os.fspath(logdir), exist_ok=True)
        self.path = os.path.join(
            os.fspath(logdir),
            f"events.out.tfevents.{int(time.time())}.{os.getpid()}",
        )
        self._f = open(self.path, "ab")
        self._record(_event_proto(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        numeric = {
            k: float(v)
            for k, v in scalars.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        if numeric:
            self._record(_event_proto(time.time(), int(step), numeric))

    def write(self, record: Mapping[str, Any]) -> None:
        value = record.get("value")
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        self.add_scalars(
            int(record.get("step", 0) or 0), {record["metric"]: value}
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- Chrome-trace-event timeline (Perfetto-viewable) ------------------------


def _is_nonfinite_sample(v) -> bool:
    """A frame-metric value the counter track cannot render: the
    ``json_safe`` string encodings, or a live non-finite float."""
    if isinstance(v, str):
        return v in ("NaN", "Infinity", "-Infinity")
    if isinstance(v, float):
        return v != v or v in (float("inf"), float("-inf"))
    return False


def flight_entries(dump: Mapping[str, Any]) -> list:
    """SpanRecorder-format entries from a flight-recorder dump —
    frames become ``train/step`` spans, the event log becomes instants
    (timestamps are already epoch seconds: ``FlightRecorder`` clocks
    ``time.time``).  Non-finite frame metrics — the crash evidence the
    dump's ``json_safe`` encoding deliberately preserves — become
    marker instants, since a counter track cannot render them and
    silently ending the track one frame early would hide exactly the
    value the flight recorder kept.  Feed the result to
    :meth:`TimelineSink.add_spans`."""
    entries = []
    prev_t = None
    for fr in dump.get("frames", []):
        t = fr.get("t")
        if isinstance(prev_t, (int, float)) and isinstance(t, (int, float)):
            args = {"step": fr.get("step"),
                    "skipped": bool(fr.get("skipped"))}
            if fr.get("replay"):
                args["replay"] = True
            entries.append({
                "name": "train/step", "track": "train",
                "t0": prev_t, "t1": t, "args": args,
            })
        prev_t = t
        if isinstance(t, (int, float)):
            for name, v in (fr.get("metrics") or {}).items():
                if _is_nonfinite_sample(v):
                    entries.append({
                        "name": f"{name} = {v}", "track": "health",
                        "t": t,
                        "args": {"metric": name, "value": str(v),
                                 "step": fr.get("step")},
                    })
    for ev in dump.get("events", []):
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        kind = ev.get("kind", "event")
        name = (
            f"health/{ev.get('rule', '?')}" if kind == "health"
            else f"train/{kind}"
        )
        track = "health" if kind == "health" else "train"
        args = {k: v for k, v in ev.items()
                if k not in ("seq", "t", "kind") and v is not None}
        entries.append({
            "name": name, "track": track, "t": t, "args": args,
        })
    return entries


def flight_counters(dump: Mapping[str, Any]) -> list:
    """``(name, t_epoch_s, value)`` counter samples from a flight
    dump's per-frame metrics — one Perfetto counter track per metric."""
    out = []
    for fr in dump.get("frames", []):
        t = fr.get("t")
        metrics = fr.get("metrics") or {}
        if not isinstance(t, (int, float)):
            continue
        for name, v in metrics.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out.append((name, t, float(v)))
    return out


class TimelineSink:
    """Chrome-trace-event JSON (the format ``ui.perfetto.dev`` and
    ``chrome://tracing`` open) — the merged-timeline sink beside
    JSONL/CSV/TensorBoard.

    Two input surfaces:

    - :meth:`add_spans` takes :class:`~apex_tpu_torch.observability.spans.
      SpanRecorder` entries (spans → ``"X"`` complete events, instants
      → ``"i"``) together with the recorder dump's **wall-clock
      anchor**, converting monotonic timestamps to epoch microseconds —
      which is what lets artifacts from different processes/hosts merge
      onto one timeline.  Each ``track`` becomes its own named thread
      row; a span's ``lane`` (e.g. a request id) becomes a sub-row.
    - :meth:`write` takes a bench-schema record (the
      :class:`Reporter` sink protocol) and emits a ``"C"`` counter
      event, so live metric lines render as counter tracks under the
      spans.

    Events buffer in memory and the JSON object is written at
    :meth:`close` (the trace format is one document, not a line
    stream).
    """

    def __init__(self, target: Union[str, os.PathLike, IO], *,
                 pid: int = 1, process_name: Optional[str] = None,
                 other_data: Optional[Mapping[str, Any]] = None):
        if hasattr(target, "write"):
            self._f, self._owns = target, False
        else:
            path = os.fspath(target)
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._f, self._owns = open(path, "w"), True
        self.pid = int(pid)
        self._events: list = []
        self._tids: Dict[Any, int] = {}
        self._procs: set = set()
        self._other: Dict[str, Any] = dict(other_data or {})
        self._closed = False
        if process_name is not None:
            self._name_process(self.pid, process_name)

    def _name_process(self, pid: int, name: str) -> None:
        if pid not in self._procs:
            self._procs.add(pid)
            self._events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name},
            })

    def _tid(self, pid: int, track: str, lane=None) -> int:
        key = (pid, track, lane)
        tid = self._tids.get(key)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[key] = tid
            label = track if lane is None else f"{track} [{lane}]"
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": label},
            })
            # keep tracks grouped by name, lanes in creation order
            self._events.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": tid},
            })
        return tid

    @staticmethod
    def _to_epoch_us(t: float, anchor: Optional[Mapping[str, Any]]) -> float:
        """Epoch microseconds for timestamp ``t`` — monotonic seconds
        when ``anchor`` carries the process's monotonic→epoch offset,
        already-epoch seconds when ``anchor`` is None (flight frames)."""
        if anchor:
            t = float(t) - float(anchor["monotonic"]) + float(
                anchor["epoch"]
            )
        return float(t) * 1e6

    def add_spans(
        self,
        entries: Iterable[Mapping[str, Any]],
        *,
        anchor: Optional[Mapping[str, Any]] = None,
        pid: Optional[int] = None,
        process_name: Optional[str] = None,
    ) -> int:
        """Append SpanRecorder-format entries; returns the event count
        added.  Pass each source file's own ``anchor`` (and a distinct
        ``pid``/``process_name`` per host) when merging."""
        pid = self.pid if pid is None else int(pid)
        if process_name is not None:
            self._name_process(pid, process_name)
        n = 0
        for e in entries:
            track = e.get("track", "events")
            tid = self._tid(pid, track, e.get("lane"))
            args = dict(e.get("args") or {})
            if "t0" in e:
                ts = self._to_epoch_us(e["t0"], anchor)
                dur = max(
                    0.0,
                    self._to_epoch_us(e["t1"], anchor) - ts,
                )
                self._events.append({
                    "name": e.get("name", "?"), "cat": track, "ph": "X",
                    "ts": ts, "dur": dur, "pid": pid, "tid": tid,
                    "args": args,
                })
            else:
                self._events.append({
                    "name": e.get("name", "?"), "cat": track, "ph": "i",
                    "ts": self._to_epoch_us(e.get("t", 0.0), anchor),
                    "s": "t", "pid": pid, "tid": tid, "args": args,
                })
            n += 1
        return n

    def counter(self, name: str, t_epoch_s: float, value: float,
                *, pid: Optional[int] = None) -> None:
        """One counter sample (epoch seconds) — renders as a counter
        track."""
        self._events.append({
            "name": name, "ph": "C",
            "ts": float(t_epoch_s) * 1e6,
            "pid": self.pid if pid is None else int(pid),
            "tid": 0, "args": {"value": float(value)},
        })

    def write(self, record: Mapping[str, Any]) -> None:
        """Reporter sink protocol: numeric bench-schema records become
        counter samples stamped with the wall clock at write time."""
        value = record.get("value")
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        v = float(value)
        if v != v or v in (float("inf"), float("-inf")):
            return  # counter tracks are numeric; non-finite has no bar
        self.counter(record["metric"], time.time(), v)

    def flush(self) -> None:
        pass  # events buffer until close — the trace is one document

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._events.sort(
            key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0))
        )
        # span args may carry forensic non-finites (a NaN health value)
        # — encode them the flight-dump way, strict JSON throughout
        from apex_tpu_torch.observability.flight import json_safe

        json.dump(
            json_safe({
                "traceEvents": self._events,
                "displayTimeUnit": "ms",
                "otherData": self._other,
            }),
            self._f,
            allow_nan=False,
        )
        self._f.write("\n")
        self._f.flush()
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Reporter:
    """Fan one step's telemetry out to every sink.

    ``report(step)`` merges, in order (later wins on key collisions):
    the registry's latest fetched values, the step meter summary, the
    goodput summary, the board snapshot, then ``extra`` — and writes
    one bench-schema record per metric to each sink.  Units come from
    the registry where declared.
    """

    def __init__(
        self,
        sinks: Iterable,
        *,
        registry=None,
        meter=None,
        goodput=None,
        include_board: bool = True,
    ):
        self.sinks = list(sinks)
        self.registry = registry
        self.meter = meter
        self.goodput = goodput
        self.include_board = include_board

    _UNITS = {
        "train/step_time_ms": "ms",
        "train/tokens_per_sec": "tokens/s",
        "train/mfu": "MFU",
        "train/goodput": "fraction (productive/executed)",
    }

    def collect(self) -> Dict[str, Any]:
        values: Dict[str, Any] = {}
        if self.registry is not None:
            values.update(self.registry.values())
        if self.meter is not None:
            values.update(self.meter.summary())
        if self.goodput is not None:
            values.update(self.goodput.summary())
        if self.include_board:
            from apex_tpu_torch.observability.metrics import board

            values.update(board.snapshot())
        return values

    def report(
        self, step: int, extra: Optional[Mapping[str, Any]] = None
    ) -> Dict[str, Any]:
        values = self.collect()
        if extra:
            values.update(extra)
        for name, value in values.items():
            unit = self._UNITS.get(name, "")
            if not unit and self.registry is not None:
                unit = self.registry.unit(name)
            rec = bench_record(name, value, unit, None, step=int(step))
            for sink in self.sinks:
                sink.write(rec)
        return values

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
