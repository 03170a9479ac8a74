"""Merge span records, flight dumps and profiler windows into one
Perfetto timeline, and gate CI on span accounting.

Counterpart of ``tools/timeline.py``, with the same flags, accounting
and exit codes::

    python -m apex_tpu_torch.tools.timeline --spans spans.json \
        [--spans more.json ...] [--flight flight_<ts>.json ...] \
        [--trace-dir DIR] [--out trace.json] [--json] [--ttft-tol-ms 1.0]

- ``--spans``: :class:`apex_tpu_torch.observability.spans.SpanRecorder`
  dumps; each carries its process's wall-clock anchor, so several
  processes' records land on one epoch-aligned timeline.
- ``--flight``: :class:`~apex_tpu_torch.observability.flight.
  FlightRecorder` dumps: frames become ``train/step`` spans, events
  instants, per-frame metrics counter tracks.
- ``--trace-dir``: a :class:`~apex_tpu_torch.observability.trace.
  TraceScheduler` base directory: each ``steps_<a>_<b>/`` window becomes
  a marker at its newest file's time.

``--out FILE`` writes Chrome-trace JSON (``ui.perfetto.dev``).
``--json`` prints the span-accounting summary and makes the exit status
enforce it (:func:`account_requests`: every request's chain ``queued ->
prefill -> [decode] -> exactly one terminal``, each TTFT equal to the
sum of its components within ``--ttft-tol-ms``, no dropped entries in a
dump that carries request chains; :func:`account_canary`: the canary
exposure bound of each deploy window, re-proven from the spans alone).
Exit status: 0 clean (always for a plain ``--out`` merge), 1 accounting
violated under ``--json``, 2 unreadable input.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

TERMINALS = ("req/done", "req/shed")
WINDOW_OPEN = "fleet/deploy_window_open"
WINDOW_CLOSE = "fleet/deploy_window_close"


def load_spans_dump(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if data.get("kind") != "apex_tpu_spans" or "spans" not in data:
        raise ValueError(f"not a span dump (kind/spans keys): {path}")
    return data


def load_flight_dump(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    for key in ("version", "reason", "frames", "events"):
        if key not in data:
            raise ValueError(f"not a flight dump: missing {key!r}: {path}")
    return data


def trace_window_entries(trace_dir: str):
    """Marker instants for each discovered profiler window dir, stamped
    with the newest artifact mtime inside (epoch seconds)."""
    entries = []
    for d in sorted(glob.glob(os.path.join(trace_dir, "steps_*_*"))):
        if not os.path.isdir(d):
            continue
        mtimes = [
            os.path.getmtime(os.path.join(root, fn))
            for root, _, files in os.walk(d) for fn in files
        ]
        if not mtimes:
            continue
        entries.append({
            "name": "trace/window", "track": "trace", "t": max(mtimes),
            "args": {"log_dir": d},
        })
    return entries


def account_requests(spans, dropped, ttft_tol_ms: float) -> dict:
    """The span-accounting invariants over the serve/requests track.

    Chains key on ``(_src, lane)``: request ids restart at 0 per
    process, so a multi-dump merge must scope each dump's rids to its
    source (``main`` tags entries with ``_src`` per input file) — two
    hosts' rid-0 chains are two requests, not one corrupt one.

    ``dropped`` is per-source too (``{src: count}``, or an int for a
    single source): only a source whose OWN ring wrapped *and* whose
    record carries request chains is unaccountable — a wrapped
    train-only dump merged beside a complete serve dump must not fail
    the serve dump's accounting.
    """
    dropped_by_src = (
        dict(dropped) if isinstance(dropped, dict)
        else {0: int(dropped or 0)}
    )
    by_rid: dict = {}
    for e in spans:
        if e.get("track") != "serve/requests":
            continue
        rid = (e.get("_src", 0), e.get("lane"))
        rec = by_rid.setdefault(
            rid, {"spans": [], "instants": [], "terminals": []}
        )
        if "t0" in e:
            rec["spans"].append(e)
        else:
            rec["instants"].append(e)
            if e.get("name") in TERMINALS:
                rec["terminals"].append(e)

    total = len(by_rid)
    admitted = complete = 0
    shed_reasons: dict = {}
    violations = []
    ttft_checked = 0
    ttft_max_err = 0.0
    for (src, lane), rec in sorted(by_rid.items(), key=lambda kv: str(kv[0])):
        rid = f"{lane}" if src == 0 else f"{lane} (dump {src})"
        names = [s["name"] for s in rec["spans"]]
        n_term = len(rec["terminals"])
        was_admitted = "req/prefill" in names
        if was_admitted:
            admitted += 1
        if n_term != 1:
            violations.append(
                f"rid={rid}: {n_term} terminal events (want exactly 1)"
            )
            continue
        term = rec["terminals"][0]
        if term["name"] == "req/shed":
            reason = (term.get("args") or {}).get("reason", "?")
            shed_reasons[reason] = shed_reasons.get(reason, 0) + 1
        if "req/queued" not in names:
            violations.append(f"rid={rid}: no req/queued span")
            continue
        if was_admitted and term["name"] == "req/done":
            # every completed request's prefill span must carry its
            # TTFT attribution, and the components must sum to the
            # measured TTFT
            args = {}
            for s in rec["spans"]:
                if s["name"] == "req/prefill":
                    args = s.get("args") or {}
            comps = [args.get(k) for k in (
                "ttft_ms", "queue_wait_ms", "prefill_ms", "contention_ms",
            )]
            if any(not isinstance(c, (int, float)) for c in comps):
                violations.append(
                    f"rid={rid}: req/prefill span missing TTFT "
                    f"attribution args (have {sorted(args)})"
                )
                continue
            ttft, qw, pf, ct = comps
            # prefix-cache component (0.0 pre-cache records, which
            # predate the key — the 3-component sum is unchanged then)
            cp = args.get("cached_prefill_ms", 0.0)
            if not isinstance(cp, (int, float)):
                violations.append(
                    f"rid={rid}: non-numeric cached_prefill_ms {cp!r}"
                )
                continue
            err = abs(ttft - (qw + cp + pf + ct))
            ttft_checked += 1
            ttft_max_err = max(ttft_max_err, err)
            if err > ttft_tol_ms:
                violations.append(
                    f"rid={rid}: TTFT components sum off by {err:.3f}ms "
                    f"(ttft={ttft:.3f}, qw={qw:.3f}, pf={pf:.3f}, "
                    f"ct={ct:.3f}; tol {ttft_tol_ms}ms)"
                )
                continue
        complete += 1
    # a wrapped ring cannot prove REQUEST-CHAIN completeness (a whole
    # chain may have been evicted) — the violation fires for any
    # source that wrapped AND shows serve activity on ANY serve/*
    # track: surviving engine spans with zero chains means the chains
    # themselves were evicted, which is exactly the truncation the
    # gate exists to catch.  A wrapped train-only record (the
    # recorder's designed steady state over a long run) claims nothing
    # about chains, so it stays clean.
    serve_srcs = {
        e.get("_src", 0) for e in spans
        if str(e.get("track", "")).startswith("serve/")
    }
    for src in sorted(serve_srcs):
        n = dropped_by_src.get(src, 0)
        if n:
            violations.append(
                f"dump {src}: ring dropped {n} entries — its request "
                "record cannot prove chain completeness (raise the "
                "recorder capacity)"
            )
    total_dropped = sum(dropped_by_src.values())
    return {
        "requests": {
            "total": total,
            "admitted": admitted,
            "complete": complete,
        },
        "shed_reasons": shed_reasons,
        "ttft_accounting": {
            "checked": ttft_checked,
            "max_error_ms": ttft_max_err,
            "tol_ms": ttft_tol_ms,
        },
        "dropped": total_dropped,
        "violations": violations,
        "ok": not violations,
    }


def account_canary(spans) -> dict:
    """Re-prove the canary exposure bound from the span dump ALONE.

    The fleet's own counters claim ``canary_routed <= frac * routed +
    1`` during a deploy window; this accounting re-derives it from the
    validated ``canary`` annotations on ``req/routed`` spans, with no
    trust in the fleet's arithmetic.  Windows pair
    ``fleet/deploy_window_open``/``_close`` instants per source, and
    membership uses the recorder's append order (``seq``) rather than
    timestamps: on a virtual clock every event in a tick shares one
    timestamp, but append order preserves the tick's phase order
    (dispatch before the window opens in the same tick is genuinely
    outside the window).

    Invariants, each a violation when broken:

    - windows nest/pair correctly (no nested open, no orphan close;
      an unclosed window extends to the end of the record);
    - INSIDE a window, a routed hop targets the canary replica iff it
      carries the ``canary`` annotation (both directions);
    - per window, annotated hops ``<= frac * routed + 1``;
    - every ``canary``-annotated hop falls inside some window (the
      recorder enforces this at write time; re-proven from the dump).
    """
    by_src: dict = {}
    for e in spans:
        by_src.setdefault(e.get("_src", 0), []).append(e)
    windows = []
    violations = []
    canary_hops = 0
    for src in sorted(by_src):
        entries = sorted(by_src[src], key=lambda e: e.get("seq", 0))
        open_evt = None
        wins = []
        for e in entries:
            if e.get("track") != "health":
                continue
            name = e.get("name")
            if name == WINDOW_OPEN:
                if open_evt is not None:
                    violations.append(
                        f"dump {src}: nested {WINDOW_OPEN} at "
                        f"seq {e.get('seq')}"
                    )
                open_evt = e
            elif name == WINDOW_CLOSE:
                if open_evt is None:
                    violations.append(
                        f"dump {src}: {WINDOW_CLOSE} without an open "
                        f"window at seq {e.get('seq')}"
                    )
                    continue
                wins.append((open_evt, e))
                open_evt = None
        if open_evt is not None:
            wins.append((open_evt, None))
        routed = [
            e for e in entries
            if e.get("track") == "serve/requests"
            and e.get("name") == "req/routed"
        ]

        def _inside(e, o, c):
            lo = o.get("seq", 0)
            hi = c.get("seq") if c is not None else float("inf")
            return lo < e.get("seq", 0) < hi

        for o, c in wins:
            oargs = o.get("args") or {}
            cname = oargs.get("canary")
            frac = oargs.get("frac")
            n_routed = n_canary = 0
            for e in routed:
                if not _inside(e, o, c):
                    continue
                args = e.get("args") or {}
                n_routed += 1
                annotated = bool(args.get("canary"))
                to_canary = args.get("replica") == cname
                if annotated:
                    n_canary += 1
                if annotated != to_canary:
                    violations.append(
                        f"dump {src}: routed span seq {e.get('seq')} "
                        f"to {args.get('replica')!r} inside the "
                        f"{cname!r} window has canary={annotated} "
                        f"(want {to_canary})"
                    )
            if not isinstance(frac, (int, float)) or not cname:
                violations.append(
                    f"dump {src}: {WINDOW_OPEN} at seq "
                    f"{o.get('seq')} missing canary/frac args "
                    f"(have {sorted(oargs)})"
                )
            elif n_canary > frac * n_routed + 1:
                violations.append(
                    f"dump {src}: window {cname!r} routed {n_canary} "
                    f"canary hops of {n_routed} — breaks the "
                    f"frac={frac} exposure bound "
                    f"(max {frac * n_routed + 1:.1f})"
                )
            windows.append({
                "src": src,
                "canary": cname,
                "frac": frac,
                "verdict": ((c.get("args") or {}).get("verdict")
                            if c is not None else None),
                "closed": c is not None,
                "routed": n_routed,
                "canary_routed": n_canary,
                "exposure_frac": (
                    n_canary / n_routed if n_routed else 0.0
                ),
            })
        for e in routed:
            if not (e.get("args") or {}).get("canary"):
                continue
            canary_hops += 1
            if not any(_inside(e, o, c) for o, c in wins):
                violations.append(
                    f"dump {src}: canary-annotated routed span seq "
                    f"{e.get('seq')} falls outside every deploy window"
                )
    return {
        "windows": windows,
        "canary_hops": canary_hops,
        "violations": violations,
        "ok": not violations,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge spans/flight/profiler artifacts into one "
        "Perfetto timeline"
    )
    ap.add_argument("--spans", action="extend", nargs="+", default=[],
                    metavar="FILE",
                    help="SpanRecorder dump(s) — repeatable, and each "
                    "flag takes several files (shell globs work)")
    ap.add_argument("--flight", action="extend", nargs="+", default=[],
                    metavar="FILE",
                    help="FlightRecorder dump(s) — repeatable/globbable")
    ap.add_argument("--trace-dir", default=None,
                    help="TraceScheduler base dir (profiler windows)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write Chrome-trace-event JSON here")
    ap.add_argument("--json", action="store_true",
                    help="print the span-accounting summary (the CI "
                    "artifact); exit 1 on violations")
    ap.add_argument("--ttft-tol-ms", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not args.spans and not args.flight and not args.trace_dir:
        ap.error("nothing to merge: give --spans, --flight or --trace-dir")

    span_dumps = []
    flight_dumps = []
    try:
        for path in args.spans:
            span_dumps.append((path, load_spans_dump(path)))
        for path in args.flight:
            flight_dumps.append((path, load_flight_dump(path)))
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"timeline: cannot read input: {e}", file=sys.stderr)
        return 2

    all_spans = []
    dropped_by_src = {}
    for i, (_, dump) in enumerate(span_dumps):
        # tag each entry with its source file: request ids restart at 0
        # per process (and ring wrap is per recorder), so accounting
        # scopes both chains and dropped counts to the dump
        all_spans.extend(
            dict(e, _src=i) for e in dump.get("spans", [])
        )
        dropped_by_src[i] = int(dump.get("dropped", 0) or 0)

    if args.out:
        from apex_tpu_torch.observability.export import (
            TimelineSink,
            flight_counters,
            flight_entries,
        )

        with TimelineSink(
            args.out,
            other_data={
                "sources": {
                    "spans": [p for p, _ in span_dumps],
                    "flight": [p for p, _ in flight_dumps],
                    "trace_dir": args.trace_dir,
                },
            },
        ) as sink:
            n = 0
            for i, (path, dump) in enumerate(span_dumps):
                host = (dump.get("host") or {}).get("id", 0)
                pid = 1 + i
                n += sink.add_spans(
                    dump.get("spans", []),
                    anchor=dump.get("anchor"),
                    pid=pid,
                    process_name=(
                        f"host{host} spans ({os.path.basename(path)})"
                    ),
                )
            for j, (path, dump) in enumerate(flight_dumps):
                host = (dump.get("host") or {}).get("id", 0)
                pid = 101 + j
                n += sink.add_spans(
                    flight_entries(dump),
                    anchor=None,  # flight timestamps are epoch already
                    pid=pid,
                    process_name=(
                        f"host{host} flight ({os.path.basename(path)})"
                    ),
                )
                for name, t, v in flight_counters(dump):
                    sink.counter(name, t, v, pid=pid)
                    n += 1
            if args.trace_dir:
                n += sink.add_spans(
                    trace_window_entries(args.trace_dir),
                    anchor=None, pid=201, process_name="profiler windows",
                )
        print(f"[timeline] wrote {args.out} ({n} events)", file=sys.stderr)

    summary = account_requests(
        all_spans, dropped_by_src, args.ttft_tol_ms
    )
    canary = account_canary(all_spans)
    summary["canary"] = canary
    summary["violations"].extend(canary["violations"])
    summary["ok"] = summary["ok"] and canary["ok"]
    summary["sources"] = {
        "spans": len(span_dumps),
        "flight": len(flight_dumps),
        "span_entries": len(all_spans),
    }
    if args.json:
        print(json.dumps(summary))
    else:
        req = summary["requests"]
        print(
            f"span accounting: {req['complete']}/{req['total']} request "
            f"chains complete ({req['admitted']} admitted), "
            f"TTFT checked on {summary['ttft_accounting']['checked']} "
            f"(max err "
            f"{summary['ttft_accounting']['max_error_ms']:.4f}ms), "
            f"shed by reason: {summary['shed_reasons'] or '{}'}"
        )
        for w in canary["windows"]:
            print(
                f"  canary window {w['canary']!r}"
                f" (dump {w['src']}): {w['canary_routed']}/"
                f"{w['routed']} hops (frac {w['exposure_frac']:.3f}"
                f" <= {w['frac']}), verdict={w['verdict']}"
            )
        for v in summary["violations"]:
            print(f"  VIOLATION: {v}")
    # the exit status is the CI gate, and the gate is --json mode: a
    # plain merge (--out) succeeds as long as the trace was written,
    # violations or not — they are printed either way
    if args.json and not summary["ok"]:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
