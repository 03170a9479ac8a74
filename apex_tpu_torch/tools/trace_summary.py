"""Summarize a profiler trace directory: the top device ops by total time.

Counterpart of ``tools/trace_summary.py``, over the Chrome traces that
``torch.profiler`` writes through :mod:`apex_tpu_torch.observability.trace`
(``<host>_<pid>.<ms>.pt.trace.json.gz``)::

    python -m apex_tpu_torch.tools.trace_summary TRACE_DIR [-n 30]
    python -m apex_tpu_torch.tools.trace_summary TRACE_DIR --attribution
    python -m apex_tpu_torch.tools.trace_summary TRACE_DIR \\
        --flight flight_<ts>.json

Device time is the trace's kernel, memcpy and memset events (a trace
with none, a CPU run, is summarized from its top-level host ops); each
row names the kernel's layer (K1-K6, cuBLAS, the optimizer) from
:data:`~apex_tpu_torch.observability.attribution.KERNEL_GROUPS`.  A
:class:`~apex_tpu_torch.observability.trace.TraceScheduler` base
directory resolves to one ``steps_<start>_<end>/`` window (``--step``,
default the latest).  ``--flight`` prints which windows overlap a flight
dump's steps and summarizes the latest of them (exit 1 when none does).
``--attribution`` adds the compute / collective / host-stall split and
the bucket shares of
:func:`~apex_tpu_torch.observability.attribution.attribute_trace`;
``--hlo`` reads a saved step record
(:class:`~apex_tpu_torch.analysis.passes.StepRecord`, as
``step_profile --hlo-out`` writes it) and prints the cost model's bucket
shares of the same step beside the trace's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
from typing import Optional, Sequence

from apex_tpu_torch.observability import attribution as A


def list_windows(log_dir: str):
    """``[(start, end, path)]`` of the trace windows under ``log_dir``
    (the ``steps_<start>_<end>/`` layout), numerically sorted."""
    windows = []
    if os.path.isdir(log_dir):
        for name in os.listdir(log_dir):
            m = re.match(r"steps_(\d+)_(\d+)$", name)
            if m:
                windows.append((int(m.group(1)), int(m.group(2)),
                                os.path.join(log_dir, name)))
    windows.sort()
    return windows


def flight_step_range(path: str):
    """The incident's steps in a flight dump: min..max over its frames
    (and the final fetched step)."""
    with open(path) as f:
        data = json.load(f)
    steps = [fr["step"] for fr in data.get("frames", ())
             if isinstance(fr.get("step"), int)]
    final = data.get("final") or {}
    if isinstance(final.get("fetched_step"), int):
        steps.append(final["fetched_step"])
    if not steps:
        raise SystemExit(f"{path}: flight dump has no step frames")
    return min(steps), max(steps)


def cross_reference_flight(log_dir: str, flight_path: str) -> Optional[str]:
    """Print which windows overlap the flight dump's steps; return the
    latest overlapping window (None when none does)."""
    lo, hi = flight_step_range(flight_path)
    windows = list_windows(log_dir)
    print(f"flight incident span: steps {lo}..{hi} ({flight_path})")
    if not windows:
        print(f"no steps_*_* trace windows under {log_dir}")
        return None
    hit = None
    for s, e, path in windows:
        overlap = s <= hi and e >= lo
        print(f"  window {s}..{e}: "
              f"{'OVERLAPS incident' if overlap else 'outside'}")
        if overlap:
            hit = path
    if hit is None:
        print("no trace window overlaps the incident — nothing was "
              "profiling when it happened (arm APEX_TPU_TRACE_STEPS or a "
              "health-escalation window next run)")
    return hit


def resolve_window(log_dir: str, step: Optional[int] = None) -> str:
    """A window directory under a base directory: the one holding
    ``step``, else the latest; a directory without windows passes
    through."""
    windows = list_windows(log_dir)
    if not windows:
        if step is not None:
            raise SystemExit(
                f"--step given but {log_dir} has no steps_*_* windows")
        return log_dir
    print("trace windows: " + ", ".join(f"{s}..{e}" for s, e, _ in windows))
    if step is None:
        return windows[-1][2]
    for s, e, path in windows:
        if s <= step <= e:
            return path
    raise SystemExit(f"no trace window contains step {step} under {log_dir}")


def load_trace(log_dir: str) -> dict:
    try:
        return A.load_trace_dir(log_dir)
    except FileNotFoundError as e:
        raise SystemExit(str(e))


def top_ops(trace: dict, like: Optional[str] = None):
    """``(rows, summary)``: rows ``(name, total_ms, count, layer)`` by
    total time, and the busy, span and source of the whole selection
    (the span over every selected event, filtered or not)."""
    events, source = A._select(trace)
    per_ms = collections.Counter()
    per_n = collections.Counter()
    tmin, tmax = float("inf"), float("-inf")
    for e in events:
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        tmin, tmax = min(tmin, ts), max(tmax, ts + dur)
        name = e.get("name", "?")
        if like and like not in name:
            continue
        per_ms[name] += dur / 1e3
        per_n[name] += 1
    rows = []
    for name, ms in per_ms.most_common():
        hit = A.kernel_layer(name) if source == "device-ops" else None
        rows.append((name, ms, per_n[name], hit[0] if hit else ""))
    span = (tmax - tmin) / 1e3 if tmax > tmin else 0.0
    return rows, {"busy_ms": sum(per_ms.values()), "span_ms": span,
                  "source": source, "events": len(events)}


def summarize(trace: dict, top: int, like: Optional[str] = None):
    rows, s = top_ops(trace, like)
    util = 100 * s["busy_ms"] / s["span_ms"] if s["span_ms"] else 0.0
    print(f"{s['source']}: {s['events']} events, busy={s['busy_ms']:.1f}ms "
          f"span={s['span_ms']:.1f}ms util={util:.1f}%\n")
    print(f"{'total_ms':>9} {'n':>6} {'avg_us':>8}  name")
    for name, ms, n, layer in rows[:top]:
        tag = f"  <- {layer}" if layer else ""
        print(f"{ms:9.2f} {n:6d} {ms / n * 1e3:8.1f}  {name[:110]}{tag}")
    return rows


def load_record(path: str):
    """A step record saved with ``torch.save`` (``step_profile
    --hlo-out``)."""
    import torch

    return torch.load(path, weights_only=False)


def print_attribution(trace: dict, hlo_path: Optional[str] = None) -> None:
    """The --attribution block: fractions and bucket shares of one
    trace, with the cost model's shares of a saved record beside."""
    meas = A.attribute_trace(trace)
    fr = meas.fractions()
    print("attribution (%s, %d op events): compute=%.3f collective=%.3f "
          "host_stall=%.3f" % (meas.source, meas.events, fr["compute"],
                               fr["collective"], fr["host_stall"]))
    cost = None
    if hlo_path and os.path.exists(hlo_path):
        cost = A.attribute_cost_model(load_record(hlo_path), device_kind="",
                                      peak_flops=1.0, hbm_bw=1.0, ici_bw=1.0
                                      ).bucket_fractions()
    for bucket, share in sorted(meas.bucket_fractions().items(),
                                key=lambda kv: -kv[1]):
        if share > 0 or (cost and cost.get(bucket)):
            extra = (f"; cost model {100 * cost.get(bucket, 0.0):5.1f}%"
                     if cost is not None else "")
            print(f"  {bucket:<18} {100 * share:5.1f}% of busy "
                  f"({meas.bucket_ms[bucket]:.2f} ms){extra}")
    print(f"  span={meas.span_ms:.1f}ms busy={meas.busy_ms:.1f}ms "
          f"stall={meas.stall_ms:.1f}ms (step_profile adds the roofline)\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir")
    ap.add_argument("-n", type=int, default=30)
    ap.add_argument("--like", default=None, help="substring filter")
    ap.add_argument("--attribution", action="store_true",
                    help="print the step-time attribution of the chosen "
                    "window")
    ap.add_argument("--step", type=int, default=None,
                    help="the window (steps_<start>_<end>/) holding this "
                    "step; default the latest, or the dir itself")
    ap.add_argument("--hlo", default=None,
                    help="a saved step record of the traced step: the "
                    "cost model's bucket shares beside the trace's")
    ap.add_argument("--flight", default=None, metavar="FILE",
                    help="a flight dump: which windows overlap its steps; "
                    "summarize the latest overlapping one")
    args = ap.parse_args(argv)
    if args.flight:
        hit = cross_reference_flight(args.log_dir, args.flight)
        if args.step is None:
            if hit is None:
                return 1
            args.log_dir = hit
        else:
            args.log_dir = resolve_window(args.log_dir, args.step)
    else:
        args.log_dir = resolve_window(args.log_dir, args.step)
    if args.hlo and not os.path.exists(args.hlo):
        print(f"[trace_summary] --hlo {args.hlo} not found; printing the "
              "summary without it")
        args.hlo = None
    trace = load_trace(args.log_dir)
    if args.attribution:
        print_attribution(trace, args.hlo)
    summarize(trace, args.n, args.like)
    return 0


if __name__ == "__main__":
    sys.exit(main())
