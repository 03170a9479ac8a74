"""Minimal resilient training loop — survives NaN bursts and preemption.

Counterpart of ``examples/simple/resilient/train_resilient.py``.  A tiny
linear-regression job wrapped in the full resilience stack: guarded amp
steps (NaN/spike skip), step-numbered checkpoints with retry,
SIGTERM-safe shutdown, and auto-resume.  Run it, kill it (``kill -TERM``
or let chaos do it), run it again — it continues where it stopped::

    python -m apex_tpu_torch.examples.train_resilient --steps 200 \\
        --dir /tmp/resilient_demo

    # with injected faults (deterministic; the x1 save fault heals on retry):
    APEX_TPU_CHAOS="grads:nan@7,8;checkpoint_save:raise:x1@5;preemption@42" \\
        python -m apex_tpu_torch.examples.train_resilient --steps 200 \\
        --dir /tmp/resilient_demo

The step is :mod:`apex_tpu_torch.train`'s guarded two-program build
(:meth:`~apex_tpu_torch.train.Trainer.build_guarded`): ``--accum K``
splits each optimizer step into K microbatches whose gradients
accumulate locally with ONE gradient sync on the boundary, over the
``--wire`` format; at world > 1 (one process per rank, the rendezvous
flags of the other examples) the data-parallel group spans the ranks.
The chaos ``grads`` site poisons the gradients between the two programs.

``--metrics-out out.jsonl`` turns on the full observability pipe: the
registry's device metrics (loss, grad norm, scaler scale, skip counts)
fetched on a cadence, a ``StepMeter`` (step time, tokens/s, MFU on the
card), a ``GoodputAccountant`` on the ``run_resilient`` observer events,
all in the bench-schema JSONL.  The final ``train/goodput`` line carries
the exact skip/rollback/retry counts of the run, so a chaos drill is
checkable from the artifact alone.  ``APEX_TPU_TRACE_STEPS="N+K"`` arms
a profiler window of steps N..N+K-1 with no further flags; the window
is attributed (compute / collective / host stall) on the way out.

Crash forensics and health monitoring are ON BY DEFAULT: a
``FlightRecorder`` (``--flight N[:DIR]``, default ring of 64 into
``<--dir>/flight/``; ``--flight 0`` disables) dumps the last steps when
the run dies, and a health ``Watchdog`` (``--no-health`` disables)
evaluates :func:`~apex_tpu_torch.observability.default_rules` — with a
``FleetAggregator`` feeding the straggler rule at world > 1 — and prints
each event.  ``--ops-port`` serves live OpenMetrics at ``/metrics``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch import observability as obs
from apex_tpu_torch.analysis.sharding import P
from apex_tpu_torch.examples._launch import add_distributed_args
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import initialize_distributed
from apex_tpu_torch.resilience import (
    GradGuard,
    ObserverFanout,
    chaos,
    run_resilient,
)
from apex_tpu_torch.train import TrainConfig, Trainer


def _world() -> int:
    d = torch.distributed
    return d.get_world_size() if d.is_available() and d.is_initialized() \
        else 1


def build_training(accum=1, wire="f32", fetch_every=8, device="cuda"):
    """The example's training program on the composable trainer: the
    toy data (numpy, seed 0), the registry, and the guarded two-program
    step from :meth:`Trainer.build_guarded` (the dp group, the DDP
    engine's ``wire`` and accumulation-boundary sync, the guarded-amp
    update, the in-step metric fold).  Returns a dict with
    ``compute_grads(params, scaler_state, batch)`` and
    ``apply_update(scaled, state, loss)`` and what :func:`main` drives
    them with: ``state``, ``batch_fn``, ``registry``, ``dp``, ``rows``,
    ``x_all``/``y_all``."""
    dp = _world()
    micro = 64  # rows per microbatch, per replica
    rows = micro * dp * accum  # rows consumed per optimizer step
    if rows > 4096:  # the toy dataset below
        raise SystemExit(
            f"--accum {accum} x dp={dp} needs {rows} rows per step "
            "but the toy dataset has 4096; lower --accum or the world"
        )
    dev = torch.device(device)
    rs = np.random.RandomState(0)
    x_np = rs.randn(4096, 8).astype(np.float32)
    w_true = rs.randn(8, 4).astype(np.float32)
    x_all = torch.from_numpy(x_np).to(dev)
    y_all = x_all @ torch.from_numpy(w_true).to(dev)

    params = {"w": torch.zeros((8, 4), dtype=torch.float32, device=dev)}
    tx = fused_adam(1e-2)
    scaler = amp.DynamicLossScaler(init_scale=2.0**10)
    guard = GradGuard(spike_factor=20.0, warmup_steps=5)

    # the registry (and its slot in the checkpointed state) exists
    # unconditionally, so the checkpoint's structure never depends on
    # --metrics-out: a run interrupted without telemetry resumes with it
    registry = obs.MetricRegistry(fetch_every=fetch_every, device=device)
    registry.gauge("train/loss", unit="mse")
    registry.counter("guard/skipped")
    for name in ("guard/found_inf", "guard/spike", "guard/grad_norm",
                 "guard/norm_ema", "guard/consecutive_skips",
                 "guard/total_skips", "guard/budget_left",
                 "amp/loss_scale", "amp/growth_tracker",
                 "amp/hysteresis"):
        registry.gauge(name)

    trainer = Trainer(TrainConfig(
        mesh={"dp": dp},
        rules=[(r".*", P())],
        wire=wire,
        update_sharding="replicate",  # the guard wants the full tree
        device=device,
    ))
    g = trainer.build_guarded(
        lambda p, b: torch.mean((b[0] @ p["w"] - b[1]) ** 2),
        params,
        tx=tx, scaler=scaler, guard=guard,
        registry=registry, accum=accum,
    )

    def batch_fn(step):
        span = x_all.shape[0] - rows  # 0 when one step eats the dataset
        lo = (step * rows) % span if span > 0 else 0
        shape = (accum, micro * dp)
        return (
            x_all[lo: lo + rows].reshape(*shape, 8),
            y_all[lo: lo + rows].reshape(*shape, 4),
        )

    return {
        "dp": dp, "micro": micro, "rows": rows,
        "x_all": x_all, "y_all": y_all,
        "state": g.state, "registry": registry,
        "tx": tx, "scaler": scaler, "guard": guard, "ddp": g.ddp,
        "trainer": trainer,
        "compute_grads": g.compute_grads, "apply_update": g.apply_update,
        "batch_fn": batch_fn,
        "expect_plan": g.expect_plan,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dir", default="/tmp/apex_tpu_resilient_demo")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches accumulated locally per optimizer "
                    "step (one gradient sync on the boundary)")
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="wire format of the boundary gradient sync")
    ap.add_argument("--ckpt-engine", default="async",
                    choices=["async", "sync"],
                    help="checkpoint save engine: async = host snapshot "
                    "+ background write (default); sync = inline")
    ap.add_argument("--metrics-out", default=None,
                    help="JSONL telemetry path — turns on the full "
                    "observability pipe")
    ap.add_argument("--fetch-every", type=int, default=8,
                    help="device->host metric fetch cadence in steps")
    ap.add_argument("--report-every", type=int, default=10,
                    help="steps between JSONL telemetry reports")
    ap.add_argument("--flight", default=None, metavar="N[:DIR]",
                    help="flight-recorder ring size (+ optional dump "
                    "dir; default 64 into <--dir>/flight; 0 disables; "
                    "APEX_TPU_FLIGHT overrides)")
    ap.add_argument("--no-health", action="store_true",
                    help="disable the health watchdog (on by default)")
    ap.add_argument("--ops-port", type=int, default=None, metavar="PORT",
                    help="serve live OpenMetrics at /metrics while the "
                    "run trains (0 = OS-assigned; APEX_TPU_OPS_PORT is "
                    "the default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    add_distributed_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.ops_port is None:
        from apex_tpu_torch.observability.ometrics import ops_port_from_env

        args.ops_port = ops_port_from_env()
    if args.device == "cpu" and args.backend == "nccl":
        args.backend = "gloo"
    initialize_distributed(
        backend=args.backend, device=args.device,
        init_method=args.init_method, num_processes=args.world_size,
        process_id=args.rank)

    t = build_training(accum=args.accum, wire=args.wire,
                       fetch_every=args.fetch_every, device=args.device)
    dp, rows = t["dp"], t["rows"]
    x_all, y_all = t["x_all"], t["y_all"]
    state, registry = t["state"], t["registry"]
    compute_grads, apply_update = t["compute_grads"], t["apply_update"]
    batch_fn = t["batch_fn"]
    print(f"devices: dp={dp}, accum={args.accum}, wire={args.wire}, "
          f"device={args.device}")

    # meter + goodput ledger run unconditionally (cheap, host-side) so
    # the flight recorder and watchdog see them with or without a JSONL
    # reporter; MFU is defined on the card only
    n_params = sum(int(p.numel()) for p in state["params"].values())
    on_card = torch.device(args.device).type == "cuda"
    meter = obs.StepMeter(
        tokens_per_step=rows,
        flops_per_step=(obs.transformer_train_flops(n_params, rows)
                        if on_card else 0.0),
    )
    goodput = obs.GoodputAccountant()
    reporter = None
    if args.metrics_out:
        reporter = obs.Reporter(
            [obs.JSONLSink(args.metrics_out)],
            registry=registry, meter=meter, goodput=goodput,
        )
    tracer = obs.TraceScheduler()  # armed by APEX_TPU_TRACE_STEPS, else no-op

    ops = None
    if args.ops_port is not None:
        mem_provider = obs.memstats.default_provider()
        monitor = (
            obs.MemStatsMonitor(mem_provider)
            if mem_provider is not None else None
        )
        ops = obs.OpsServer(
            registries=[registry],
            collect=monitor.sample if monitor is not None else None,
            port=args.ops_port,
        ).start()
        print(f"ops: live OpenMetrics at {ops.url}")

    # flight recorder: env > --flight > default ring of 64, resolved to
    # ONE spec, so APEX_TPU_FLIGHT=0 genuinely disables
    spec = os.environ.get(obs.ENV_FLIGHT) or args.flight or "64"
    flight = obs.FlightRecorder.from_env(
        spec,
        directory=os.path.join(args.dir, "flight"),
        run={"example": "train_resilient", "steps": args.steps,
             "accum": args.accum, "wire": args.wire, "dp": dp},
    )
    if flight is not None:
        flight.attach(registry=registry, meter=meter, goodput=goodput)

    # fleet aggregation feeds the straggler rule at world > 1 (one
    # asynchronous all-gather on the fetch cadence)
    fleet = None
    if dp > 1:
        fleet = obs.FleetAggregator(
            ("train/step_time_ms", "train/mfu", "train/loss"),
            every=args.fetch_every,
        )

    watchdog = None
    if not args.no_health:
        watchdog = obs.Watchdog(
            registry=registry, meter=meter, goodput=goodput, fleet=fleet,
            reporter=reporter, flight=flight,
            on_unhealthy=lambda ev: print(
                f"  [health/{ev.severity}] {ev.rule}: {ev.message}"
            ),
            check_every=max(1, args.fetch_every // 2),
        )

    def step_fn(state, batch):
        step = int(state["guard"].step)
        tracer.on_step(step)
        loss, scaled = compute_grads(state["params"], state["scaler"], batch)
        # chaos GRADS site: poisons the tree on scheduled steps, no-op else
        scaled = chaos.corrupt_tree(scaled, step)
        new_state, verdict = apply_update(scaled, state, loss)
        registry.observe(step, new_state["metrics"])
        meter.tick()
        if fleet is not None:
            fleet.observe(step, {**registry.values(), **meter.summary()})
        if reporter is not None and step % args.report_every == 0:
            reporter.report(step)
        if bool(verdict.skipped):
            print(f"  step skipped (found_inf={float(verdict.found_inf)}, "
                  f"spike={bool(verdict.spike)})")
        return new_state, {"skipped": verdict.skipped, "loss": loss}

    result = None
    try:
        result = run_resilient(
            step_fn,
            state,
            batch_fn,
            directory=args.dir,
            num_steps=args.steps,
            save_interval_steps=args.save_every,
            max_to_keep=3,
            rollback_after=5,
            observer=ObserverFanout([goodput, watchdog]),
            flight=flight,
            checkpoint=args.ckpt_engine,
        )
    finally:
        # even a raising run must close an armed trace window and land
        # its final telemetry — those are the artifacts that debug it
        tracer.stop()
        # a captured window is attributed on the way out: the split
        # lands on the board (the watchdog fraction rules' source) and,
        # with --metrics-out, in the JSONL
        if tracer.log_dir and os.path.isdir(tracer.log_dir):
            try:
                from apex_tpu_torch.observability import attribution as attr

                meas = attr.attribute_trace_dir(tracer.log_dir)
                fr = attr.publish_attribution(meas, reporter=reporter)
                print(
                    "trace attribution (steps %s..%s, %s): compute=%.3f "
                    "collective=%.3f host_stall=%.3f"
                    % (tracer.start, tracer.end, meas.source,
                       fr["compute"], fr["collective"], fr["host_stall"])
                )
            except Exception as e:  # the postmortem must not eat the run
                print(f"trace attribution failed: {e}", file=sys.stderr)
        if ops is not None:
            ops.stop()
        if reporter is not None:
            registry.fetch()  # drain the async buffers for the report
            final_step = (
                max(result.last_step, 0) if result is not None
                else meter.steps
            )
            reporter.report(final_step)
            # the consolidated goodput line: value + the EXACT event
            # counts of this invocation (the accountant saw every
            # on_step / on_rollback the runner counted)
            snap = goodput.snapshot()
            reporter.sinks[0].write(obs.bench_record(
                "train/goodput", snap["goodput"],
                "fraction (productive/executed)", None,
                step=final_step, accepted=snap["accepted"],
                skipped=snap["skipped"], discarded=snap["discarded"],
                rollbacks=snap["rollbacks"], retries=snap["retries"],
                resumes=snap["resumes"], preempted=snap["preempted"],
            ))
            reporter.close()
    print(
        f"done: last_step={result.last_step} resumed_from={result.resumed_from} "
        f"steps_run={result.steps_run} skipped={result.skipped_steps} "
        f"rollbacks={result.rollbacks} preempted={result.preempted}"
    )
    saves = obs.board.get("goodput/ckpt/saves")
    if saves:
        print(
            "ckpt: engine=%s saves=%d writes=%d stall_frac=%.5f "
            "last_write=%.1fms"
            % (args.ckpt_engine, saves,
               obs.board.get("goodput/ckpt/writes", 0),
               obs.board.get("goodput/ckpt/stall_frac", 0.0),
               obs.board.get("goodput/ckpt/last_write_ms", 0.0))
        )
    w = result.state["params"]["w"]
    final_loss = float(torch.mean((x_all @ w - y_all) ** 2))
    print(f"final loss: {final_loss:.6f}")
    return result


if __name__ == "__main__":
    main()
