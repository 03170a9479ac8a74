"""Render a flight-recorder dump into a human postmortem timeline.

Counterpart of ``tools/flight_view.py``.  Usage::

    python -m apex_tpu_torch.tools.flight_view flight_<ts>.json [--json] [-n 16]

A :class:`~apex_tpu_torch.observability.flight.FlightRecorder` dump
holds the last N steps' telemetry frames, the event log (rollbacks,
resumes, retries, preemption, health events), the final drained metric
values, and the goodput ledger.  This tool turns that JSON into the
first five minutes of an incident review:

- the header: what killed the run, when, on which host;
- the merged timeline: frames and events interleaved by ``seq``, skips
  and replay passes marked;
- the last frame's metric table next to the FINAL drained values — the
  guard/scaler state at death;
- the goodput ledger (exact skip/rollback/retry counts).

``--json`` prints a one-line machine summary instead (reason + frame/
event/skip/rollback counts).  ``--timeline OUT`` emits the dump as
Chrome-trace-event JSON through
:class:`~apex_tpu_torch.observability.export.TimelineSink` (frames as
``train/step`` spans, events as instants, frame metrics as counter
tracks), so a crash postmortem opens in the same Perfetto viewer as
live span traces (``apex_tpu_torch.tools.timeline``).  The dump is read
as JSON: no device is touched.  Exit status: 0 on a parseable dump, 2
otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _num(value):
    """Undo the dump's non-finite encoding ("NaN"/"Infinity"/...)."""
    if value == "NaN":
        return float("nan")
    if value == "Infinity":
        return float("inf")
    if value == "-Infinity":
        return float("-inf")
    return value


def _fmt(value) -> str:
    value = _num(value)
    if isinstance(value, bool):
        return str(value)
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def load_dump(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    for key in ("version", "reason", "frames", "events"):
        if key not in data:
            raise ValueError(f"not a flight dump: missing {key!r} key")
    return data


def summarize(data: dict) -> dict:
    """Machine summary: the counts the CI gate cross-checks against the
    JSONL goodput line."""
    frames = data["frames"]
    events = data["events"]
    out = {
        "reason": data["reason"],
        "frames": len(frames),
        "events": len(events),
        "frame_skips": sum(1 for f in frames if f.get("skipped")),
        "rollbacks": sum(1 for e in events if e["kind"] == "rollback"),
        "retries": sum(1 for e in events if e["kind"] == "retry"),
        "health_events": sum(1 for e in events if e["kind"] == "health"),
        "preempted": any(e["kind"] == "preempt" for e in events),
    }
    goodput = data.get("goodput")
    if goodput:
        out["goodput"] = goodput
    return out


def render(data: dict, last_frames: int = 16) -> None:
    host = data.get("host", {})
    when = data.get("wall_time")
    when_s = (
        time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(when))
        if isinstance(when, (int, float)) else "?"
    )
    print(f"flight recorder postmortem — {when_s}")
    print(f"  reason : {data['reason']}")
    print(f"  host   : {host.get('id', '?')}/{host.get('count', '?')}"
          f"  capacity: {data.get('capacity', '?')}")
    run = data.get("run") or {}
    if run:
        print("  run    : " + ", ".join(f"{k}={v}" for k, v in run.items()))

    goodput = data.get("goodput")
    if goodput:
        print(
            "  goodput: {goodput:.3f} (accepted={accepted} "
            "skipped={skipped} discarded={discarded} "
            "rollbacks={rollbacks} retries={retries} "
            "resumes={resumes}{p})".format(
                p=", PREEMPTED" if goodput.get("preempted") else "",
                **{k: goodput.get(k, 0) for k in (
                    "goodput", "accepted", "skipped", "discarded",
                    "rollbacks", "retries", "resumes")},
            )
        )

    # merged timeline, frames + events ordered by seq
    frames = [dict(f, _what="frame") for f in data["frames"]]
    events = [dict(e, _what="event") for e in data["events"]]
    timeline = sorted(frames + events, key=lambda r: r.get("seq", 0))
    if last_frames and len(timeline) > last_frames:
        dropped = len(timeline) - last_frames
        timeline = timeline[-last_frames:]
        print(f"\ntimeline (last {last_frames}; {dropped} earlier "
              "entries in the dump):")
    else:
        print("\ntimeline:")
    t0 = timeline[0].get("t") if timeline else None
    for row in timeline:
        dt = ""
        if isinstance(row.get("t"), (int, float)) and isinstance(
            t0, (int, float)
        ):
            dt = f"+{row['t'] - t0:7.2f}s"
        if row["_what"] == "frame":
            marks = []
            if row.get("skipped"):
                marks.append("SKIPPED")
            if row.get("replay"):
                marks.append("replay")
            extra = f"  [{', '.join(marks)}]" if marks else ""
            stale = ""
            if row.get("fetched_step") is not None:
                stale = f"  (metrics@{row['fetched_step']})"
            print(f"  {dt:>10}  step {row.get('step', '?'):>6}"
                  f"{extra}{stale}")
        else:
            desc = ", ".join(
                f"{k}={_fmt(v)}" for k, v in row.items()
                if k not in ("_what", "seq", "t", "kind") and v is not None
            )
            print(f"  {dt:>10}  ** {row['kind'].upper()}  {desc}")

    # the state at death: last frame's (possibly stale) metrics next to
    # the final drained values
    final = data.get("final") or {}
    last_metrics = {}
    for f in reversed(data["frames"]):
        if f.get("metrics"):
            last_metrics = f["metrics"]
            break
    final_metrics = final.get("metrics") or {}
    names = sorted(set(last_metrics) | set(final_metrics))
    if names:
        print(f"\nstate at death (final = drained at dump; "
              f"last-frame fetch@{final.get('fetched_step', '?')}):")
        width = max(len(n) for n in names)
        print(f"  {'metric':<{width}}  {'last frame':>14}  {'final':>14}")
        for name in names:
            lv = _fmt(last_metrics.get(name, ""))
            fv = _fmt(final_metrics.get(name, ""))
            flag = "  <-- " if lv != fv else ""
            print(f"  {name:<{width}}  {lv:>14}  {fv:>14}{flag}")
    meter = final.get("meter")
    if meter:
        print("\nmeter at death: " + "  ".join(
            f"{k.split('/')[-1]}={_fmt(v)}" for k, v in meter.items()
        ))
    board = data.get("board") or {}
    health_keys = {k: v for k, v in board.items()
                   if k.startswith(("health/", "fleet/"))}
    if health_keys:
        print("\nhealth/fleet board:")
        for k in sorted(health_keys):
            print(f"  {k} = {_fmt(health_keys[k])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a FlightRecorder dump as a postmortem"
    )
    ap.add_argument("dump", help="flight_<ts>.json path")
    ap.add_argument("-n", type=int, default=16,
                    help="timeline entries to show (default 16)")
    ap.add_argument("--json", action="store_true",
                    help="print a one-line machine summary instead")
    ap.add_argument("--timeline", metavar="OUT", default=None,
                    help="write the dump as Chrome-trace-event JSON "
                    "(Perfetto-viewable, same format as "
                    "apex_tpu_torch.tools.timeline)")
    args = ap.parse_args(argv)
    try:
        data = load_dump(args.dump)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"flight_view: cannot read {args.dump}: {e}",
              file=sys.stderr)
        return 2
    if args.timeline:
        from apex_tpu_torch.observability.export import (
            TimelineSink,
            flight_counters,
            flight_entries,
        )

        host = (data.get("host") or {}).get("id", 0)
        with TimelineSink(
            args.timeline,
            process_name=f"host{host} flight ({args.dump})",
            other_data={"reason": data.get("reason"),
                        "anchor": data.get("anchor")},
        ) as sink:
            n = sink.add_spans(flight_entries(data), anchor=None)
            for name, t, v in flight_counters(data):
                sink.counter(name, t, v)
                n += 1
        print(f"[flight_view] wrote {args.timeline} ({n} events)",
              file=sys.stderr)
    if args.json:
        print(json.dumps(summarize(data)))
    else:
        render(data, last_frames=args.n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
