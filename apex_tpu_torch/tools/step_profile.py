"""Step-time attribution and roofline of a real training step.

Counterpart of ``tools/step_profile.py``: builds a target's actual step,
profiles ``--steps`` steady-state steps, and decomposes them two ways —

- the cost model: one recorded run of the step
  (:func:`apex_tpu_torch.analysis.passes.capture`'s
  :class:`~apex_tpu_torch.analysis.passes.StepRecord`: every aten op and
  kernel launch costed by :mod:`apex_tpu_torch.analysis.hlo`'s shape
  arithmetic and bucketed), and
- the measured trace (``torch.profiler`` through
  :mod:`apex_tpu_torch.observability.trace`: each device event's time,
  and the host stall no event covers) —

then prints the compute / collective / host-stall fractions (they sum
to 1), the per-bucket roofline on :mod:`~apex_tpu_torch.observability.
meter`'s peaks, the MFU pin against a live
:class:`~apex_tpu_torch.observability.meter.StepMeter` over the same
steps (one FLOP count and one peak, so it fails only if a second model
creeps in), the trace's own step period against the host's, and the
watchdog's verdict on the fractions.  Targets:

- ``resilient``: :func:`apex_tpu_torch.examples.train_resilient.
  build_training`'s guarded two-program step (the reference's target);
- ``gpt``: :mod:`apex_tpu_torch.examples.train_gpt`'s step at
  ``GptConfig()`` (``--batch``, ``--seq-len`` and ``--tiny`` as that
  example takes them), which launches K1-K4; the
  report adds the launch counters zeroed before the profiled steps and
  read after, beside the trace's kernel events by layer.

::

    python -m apex_tpu_torch.tools.step_profile --target resilient
    python -m apex_tpu_torch.tools.step_profile --target gpt --steps 3 \\
        --json profile.json --metrics-out attr.jsonl
    python -m apex_tpu_torch.tools.step_profile --hlo step.record

``--hlo-out FILE`` saves the recorded step (``torch.save``); ``--hlo
FILE ...`` reads saved records instead of running a target (the cost
model alone).  Exit code 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_kind(device) -> str:
    return (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "NVIDIA H100")


def _build_resilient(args):
    """``(records, step, rows, state)``: the two programs of the guarded
    step recorded once, the step as a callable of the state, the rows a
    step consumes."""
    from apex_tpu_torch.analysis import passes
    from apex_tpu_torch.examples.train_resilient import build_training

    t = build_training(accum=args.accum, wire=args.wire, device=args.device)
    state, batch_fn = t["state"], t["batch_fn"]
    compute_grads, apply_update = t["compute_grads"], t["apply_update"]
    batch = batch_fn(0)
    (loss, scaled), rec_grads = passes.capture(
        lambda: compute_grads(state["params"], state["scaler"], batch),
        named={"params": state["params"], "batch": batch})
    (state, _), rec_update = passes.capture(
        lambda: apply_update(scaled, state, loss),
        named={"scaled": scaled, "state": state})

    def step(state, i):
        loss, scaled = compute_grads(state["params"], state["scaler"],
                                     batch_fn(i))
        new_state, _ = apply_update(scaled, state, loss)
        float(loss)  # the host waits for the step: its honest boundary
        return new_state

    return [rec_grads, rec_update], step, t["rows"], state


def _build_gpt(args):
    """The same for :mod:`~apex_tpu_torch.examples.train_gpt`'s step at
    world 1: the whole step (forward, backward, FusedAdam) recorded once
    as one program."""
    from apex_tpu_torch.analysis import passes
    from apex_tpu_torch.examples import train_gpt

    argv = ["--batch", str(args.batch), "--seq-len", str(args.seq_len),
            "--device", args.device]
    if args.tiny:
        argv.append("--tiny")
    gargs = train_gpt.parse_args(argv)
    cfg, model, opt, batches, ddp = train_gpt.build(gargs)
    ids = next(batches)
    _, record = passes.capture(
        lambda: train_gpt.train_step(model, opt, ids, ddp),
        named={"params": dict(model.named_parameters()), "batch": ids})

    def step(state, i):
        loss = train_gpt.train_step(model, opt, next(batches), ddp)
        float(loss)
        return state

    return [record], step, args.batch * args.seq_len, None


def profile_target(args):
    """Build the target, record it for the cost model, warm it up,
    then profile ``--steps`` steps under a :class:`StepMeter`; returns
    ``(cost, measured, meter, trace_dir, trace_step_s, launches)``."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.observability import attribution as A
    from apex_tpu_torch.observability import trace as tr
    from apex_tpu_torch.ops import _dispatch

    build = _build_gpt if args.target == "gpt" else _build_resilient
    records, step, rows, state = build(args)
    cost = A.attribute_cost_model(records,
                                  device_kind=_device_kind(args.device))
    if args.hlo_out:
        torch.save(records if len(records) > 1 else records[0],
                   args.hlo_out)
    # one FLOP count (the cost model's, one step) and one peak for the
    # meter and the roofline; two clocks: the meter's host ticks and the
    # trace's own period
    meter = obs.StepMeter(tokens_per_step=rows,
                          flops_per_step=cost.total_flops,
                          peak_flops=cost.peak_flops)
    state = step(state, 1)  # warm-up outside the window
    _sync(args.device)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="step_profile_")
    _dispatch.reset_launches()
    meter.tick()
    with tr.trace(trace_dir):
        for i in range(args.steps):
            state = step(state, 2 + i)
            meter.tick()
        _sync(args.device)
    launches = {k: n for k, n in _dispatch.launches().items() if n}
    trace = A.load_trace_dir(trace_dir)
    measured = A.attribute_trace(trace)
    return (cost, measured, meter, trace_dir, A.trace_step_period(trace),
            launches)


def profile_records(paths):
    """The cost model alone over saved step records."""
    from apex_tpu_torch.observability import attribution as A

    records = []
    for path in paths:
        got = torch.load(path, weights_only=False)
        records.extend(got if isinstance(got, (list, tuple)) else [got])
    return A.attribute_cost_model(records, device_kind="NVIDIA H100")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="step-time attribution + "
                                 "roofline of a real training step")
    ap.add_argument("--target", choices=["resilient", "gpt"], default=None)
    ap.add_argument("--hlo", nargs="+", metavar="FILE", default=None,
                    help="attribute saved step record(s) instead of "
                    "profiling a target (cost model only)")
    ap.add_argument("--steps", type=int, default=8,
                    help="steady-state steps to profile (default 8)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--wire", default="f32", choices=["f32", "bf16", "int8"])
    ap.add_argument("--batch", type=int, default=8,
                    help="--target gpt: the global batch")
    ap.add_argument("--seq-len", type=int, default=2048,
                    help="--target gpt: the sequence length")
    ap.add_argument("--tiny", action="store_true",
                    help="--target gpt: train_gpt's tiny configuration")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profile here (default: a temp dir)")
    ap.add_argument("--hlo-out", metavar="FILE", default=None,
                    help="also save the recorded step")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the full report as one JSON object")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="append the attribution fractions as "
                    "bench-schema JSONL")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if bool(args.target) == bool(args.hlo):
        ap.error("exactly one of --target / --hlo is required")

    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.observability import attribution as A
    from apex_tpu_torch.ops._dispatch import resolve_device

    launches = None
    if args.target:
        resolve_device(args.device)  # the card unless the caller asks
        cost, measured, meter, trace_dir, trace_step_s, launches = \
            profile_target(args)
    else:
        cost, measured, meter, trace_dir = profile_records(args.hlo), \
            None, None, None
        trace_step_s = 0.0

    src = measured if measured is not None else cost
    fractions = src.fractions()
    frac_sum = sum(fractions.values())
    print("step fractions (%s): compute=%.3f collective=%.3f "
          "host_stall=%.3f  (sum=%.3f)"
          % (measured.source if measured is not None else "cost model",
             fractions["compute"], fractions["collective"],
             fractions["host_stall"], frac_sum))
    cost_fr = cost.fractions()
    if measured is not None:
        print("cost-model cross-check: collective=%.3f (measured %.3f); "
              "host stall is invisible to the recorded program"
              % (cost_fr["collective"], fractions["collective"]))

    # the roofline's step time is the meter's: one denominator, so the
    # MFU agreement below is a consistency pin
    step_time = meter.step_time if meter is not None else cost.est_step_time
    rows = A.roofline_report(cost, step_time_s=step_time, measured=measured)
    print()
    print(A.render_roofline(rows))
    roofline_mfu = rows[-1].pct_peak
    meter_mfu = meter.mfu if meter is not None else roofline_mfu
    agreement = (abs(roofline_mfu - meter_mfu) / meter_mfu
                 if meter_mfu > 0 else 0.0)
    print("\nMFU: roofline=%.4f meter=%.4f (delta %.2f%%; one denominator "
          "by design: observability.meter)"
          % (roofline_mfu, meter_mfu, 100 * agreement))
    if trace_step_s > 0 and meter is not None and meter.step_time > 0:
        skew = abs(trace_step_s - meter.step_time) / meter.step_time
        print("clock skew: trace step %.3f ms vs host step %.3f ms (%.1f%% "
              "— execution pacing vs dispatch pacing)"
              % (trace_step_s * 1e3, meter.step_time * 1e3, 100 * skew))
    if measured is not None:
        print(f"kernel events by layer: {measured.kernel_events}")
        if launches is not None:
            print(f"launches over the profiled steps: {launches}")

    reporter = None
    if args.metrics_out:
        reporter = obs.Reporter([obs.JSONLSink(args.metrics_out)])
    A.publish_attribution(src, reporter=reporter, step=0)
    if reporter is not None:
        reporter.close()

    wd = obs.Watchdog(rules=[obs.CollectiveFractionRule(),
                             obs.HostStallRule()],
                      attribution=src, check_every=1)
    events = wd.check(0)
    for ev in events:
        print(f"[health/{ev.severity}] {ev.rule}: {ev.message}")
    if not events:
        print("watchdog: collective/host-stall fractions within floors")

    if args.json:
        payload = {
            "target": args.target or "hlo",
            "source": (measured.source if measured is not None
                       else "cost-model"),
            "fractions": fractions,
            "fraction_sum": frac_sum,
            "cost_fractions": cost_fr,
            "bucket_fractions": src.bucket_fractions(),
            "cost_buckets": cost.buckets,
            "step_time_ms": step_time * 1e3,
            "trace_step_ms": trace_step_s * 1e3,
            "roofline": [r._asdict() for r in rows],
            "mfu": {"roofline": roofline_mfu, "meter": meter_mfu,
                    "agreement": agreement},
            "health_events": [ev._asdict() for ev in events],
            "trace_dir": trace_dir,
            "kernel_events": (measured.kernel_events
                              if measured is not None else {}),
            "launches": launches or {},
            "steps": args.steps if args.target else 0,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.write("\n")
        print(f"[step_profile] wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
