"""Fleet control-plane drill — the fleet acceptance gate.

Counterpart of ``tools/fleet_drill.py``.  One seeded storm — a **replica
crash**, a **preemption**, a **traffic spike**, router faults and a
**rolling deploy** against an autoscaled multi-replica
:class:`~apex_tpu_torch.fleetctl.Fleet` — runs next to a fault-free
reference fleet of the same size under the same traffic, on a
deterministic virtual clock, and the drill holds the five guarantees:

1. **zero lost accepted requests** — every submitted request reaches
   exactly one fleet-wide terminal, no span chain is left open, and the
   rolling deploy's ``lost_requests`` is 0 (drains re-route through the
   fleet door);
2. **zero leaked pages, per replica** — ``PagePool.leak_check`` on EVERY
   replica at the end, crashed, ejected and scaled-in ones included;
3. **every fleet chaos site fired and was ledgered** —
   ``fleet.replica_crash`` / ``fleet.preempt`` / ``fleet.router`` show up
   1:1 on ``fleet/replica_crashes``, ``fleet/preempts``,
   ``fleet/router_faults``;
4. **the autoscaler scaled** — at least one scale-out and one scale-in,
   on the counters and as ``fleet_scale_*`` health events;
5. **bounded degradation** — fleet p99 end-to-end TTFT within
   ``--max-p99-inflation`` of the fault-free fleet's.

A replica fleet's engines share one prepared copy of the weights (the
reference's engines share one parameter tree); a redeploy gives a
replica weights of its own.  The arrivals and prompts are drawn by numpy
from ``--seed`` exactly as the reference drill draws them, and no
scheduler decision depends on token values, so the ledger (terminals,
shed reasons, TTFT ticks, fleet counters, scale events) is the
reference's for the same flags, whatever the model's width.

Usage (the card by default; ``--device cpu`` runs the plain versions)::

    python -m apex_tpu_torch.tools.fleet_drill --json OUT.json \\
        --spans SPANS.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

#: the default storm: every fleet chaos site fires at least once.
#: Indices are FLEET TICKS (one ``Fleet.step`` per tick): router blips
#: at ticks 20/21, a replica crash at 120 (mid-load), a preemption
#: notice at 260 (mid-spike).
DEFAULT_CHAOS_SPEC = (
    "fleet.router:raise:x2@20,21;"
    "fleet.replica_crash:kill:x1@120;"
    "fleet.preempt:notice:x1@260"
)

#: injected fault counts per fleet ledger counter the artifact must
#: show — derived from DEFAULT_CHAOS_SPEC (a custom --chaos skips)
DEFAULT_EXPECTED = {
    "fleet/router_faults": 2,
    "fleet/replica_crashes": 1,
    "fleet/preempts": 1,
}


def model_configs(args):
    """``(GptConfig, ServeConfig)`` of the parser's widths (f32)."""
    from apex_tpu_torch.models import GptConfig
    from apex_tpu_torch.serve import ServeConfig

    cfg = GptConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.heads,
        intermediate_size=2 * args.hidden, max_seq_len=256,
        dtype=torch.float32,
    )
    serve_cfg = ServeConfig(
        page_size=args.page_size, num_pages=args.pages,
        max_batch=args.batch, max_pages_per_seq=args.pages_per_seq,
        verify=args.verify,
    )
    return cfg, serve_cfg


def make_params(args, key: int, configs=model_configs):
    """Seeded random weights (``key`` seeds the generator) on
    ``--device``."""
    from apex_tpu_torch.models import GptModel

    cfg, _ = configs(args)
    gen = torch.Generator(args.device).manual_seed(key)
    return GptModel(cfg, device=args.device, generator=gen)


class VirtualClock:
    """One fixed tick per fleet step: TTFT measures fleet SCHEDULING
    delay (door wait, queue wait, re-route round trips, drain grace) in
    tick units, reproducibly per seed."""

    def __init__(self, tick_s: float = 0.005):
        self.t = 0.0
        self.tick_s = tick_s

    def __call__(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.tick_s


def engine_factory(args, params, configs=model_configs):
    """A factory of built engines over ``params`` whose engines share the
    first one's prepared weights."""
    from apex_tpu_torch.serve import InferenceEngine

    cfg, serve_cfg = configs(args)
    shared = []

    def build(registry):
        engine = InferenceEngine(
            cfg, params, serve_cfg, registry=registry, device=args.device,
            weights=shared[0] if shared else None,
        ).build()
        if not shared:
            shared.append(engine.weights)
        return engine

    return build


def build_fleet(args, clock, params, *, recorder=None, scaled=False,
                configs=model_configs):
    from apex_tpu_torch.fleetctl import (
        Autoscaler,
        AutoscalerConfig,
        EngineReplica,
        Fleet,
    )
    from apex_tpu_torch.observability import MetricRegistry

    build = engine_factory(args, params, configs)

    def factory(name: str) -> EngineReplica:
        registry = MetricRegistry(fetch_every=1)
        return EngineReplica(
            name, build(registry), clock=clock, spans=recorder,
            max_queue_depth=args.max_queue_depth,
            clamp_max_new_tokens=args.clamp_max_new_tokens,
            clamp_occupancy=args.clamp_occupancy,
            max_retries=args.max_retries,
        )

    autoscaler = None
    if scaled:
        autoscaler = Autoscaler(AutoscalerConfig(
            min_replicas=1, max_replicas=args.max_replicas,
            ttft_threshold_ms=args.ttft_threshold_ms,
            short_window_s=50 * clock.tick_s,
            long_window_s=400 * clock.tick_s,
            out_factor=args.out_factor,
            queue_high=args.queue_high, queue_low=args.queue_low,
            headroom_evals=3, cooldown_ticks=args.cooldown_ticks,
            eval_every=4,
        ), clock=clock)
    return Fleet(
        factory, replicas=args.replicas, clock=clock, spans=recorder,
        autoscaler=autoscaler,
    )


def gen_arrivals(args, rs):
    """Time-varying Poisson arrivals: the base rate with a
    ``spike_factor`` burst over [spike_start, spike_end) virtual
    seconds — the traffic spike the autoscaler must absorb."""
    arrivals = []
    t = 0.0
    for _ in range(args.requests):
        rate = args.rate * (
            args.spike_factor
            if args.spike_start <= t < args.spike_end else 1.0
        )
        t += rs.exponential(1.0 / rate)
        arrivals.append(t)
    return arrivals


def ledger(reqs, tick_s: float) -> list:
    """Each request's scheduling outcome: ``(status, shed_reason, retries,
    TTFT in ticks)`` — what no token value decides."""
    return [
        (r.status, r.shed_reason, r.retries,
         None if r.ttft_ms is None else round(r.ttft_ms / (1e3 * tick_s)))
        for r in reqs
    ]


def ledger_digest(rows) -> str:
    return hashlib.blake2b(json.dumps(rows).encode(),
                           digest_size=8).hexdigest()


def run_fleet_load(fleet, clock, args, *, label, deploy_params=None,
                   tail_ticks=1, keep=None):
    """Drive one seeded load through a fleet on the virtual clock:
    submissions at the door, one ``Fleet.step`` per tick, a rolling
    update started at ``--deploy-tick`` when ``deploy_params`` is given,
    then ``tail_ticks`` idle ticks (the headroom a scale-in needs).
    ``keep`` (a list) receives the requests."""
    from apex_tpu_torch.observability.meter import percentile
    from apex_tpu_torch.serve import Request

    rs = np.random.RandomState(args.seed)
    arrivals = gen_arrivals(args, rs)
    prompt_lens = rs.choice(args.prompt_mix, size=args.requests)
    out_lens = rs.choice(args.output_mix, size=args.requests)

    submitted = 0
    reqs = keep if keep is not None else []
    deployed = False
    idle = 0
    for _ in range(args.max_ticks):
        now = clock()
        while submitted < args.requests and arrivals[submitted] <= now:
            reqs.append(fleet.submit(Request(
                prompt=[int(t) for t in rs.randint(
                    0, args.vocab, size=prompt_lens[submitted])],
                max_new_tokens=int(out_lens[submitted]),
            )))
            submitted += 1
        if (
            deploy_params is not None and not deployed
            and fleet.tick >= args.deploy_tick
        ):
            fleet.start_rolling_update(deploy_params)
            deployed = True
        fleet.step()
        clock.advance()
        if submitted >= args.requests and not fleet.pending:
            idle += 1
            if idle >= tail_ticks:
                break
        else:
            idle = 0
    else:
        raise RuntimeError(
            f"{label}: fleet did not settle within {args.max_ticks} "
            f"ticks (door={fleet.door_depth}, deploy={fleet.deploy})"
        )

    done = [r for r in reqs if r.status == "done"]
    shed = [r for r in reqs if r.status == "shed"]
    ttfts = sorted(r.ttft_ms for r in done if r.ttft_ms is not None)
    shed_reasons = {}
    for r in shed:
        key = r.shed_reason or "?"
        shed_reasons[key] = shed_reasons.get(key, 0) + 1
    return {
        "label": label,
        "offered": len(reqs),
        "completed": len(done),
        "shed": len(shed),
        "shed_reasons": shed_reasons,
        "unterminated": [
            r.rid for r in reqs if r.status not in ("done", "shed")
        ],
        "retries_total": sum(r.retries for r in reqs),
        "ttft_ms": {
            "p50": percentile(ttfts, 0.50),
            "p99": percentile(ttfts, 0.99),
            "samples": len(ttfts),
        },
        "ticks": fleet.tick,
        "wall_s": clock(),
        "deployed": deployed,
        "ledger_digest": ledger_digest(ledger(reqs, clock.tick_s)),
    }


def ops_check(fleet) -> dict:
    """N replicas in one process each export ``/metrics`` on an
    OS-assigned port (no collision), and the router-side aggregation
    folds their scrapes into one fleet view.  EVERY replica that ever
    served exports — dead ones still hold their ledger."""
    started = [rep.start_ops() for rep in fleet.replicas]
    try:
        ports = [srv.bound_port for srv in started]
        agg = fleet.aggregate_scrapes()
    finally:
        for rep in fleet.replicas:
            rep.stop_ops()
    return {
        "servers": len(started),
        "ports": ports,
        "distinct_ports": len(set(ports)) == len(ports),
        "all_bound": all(p and p > 0 for p in ports),
        "aggregated_sources": agg["sources"],
        "aggregated_completed": agg["counters"].get(
            "apex_serve_completed_count_total",
            agg["counters"].get("serve/completed"),
        ),
        "counter_families": len(agg["counters"]),
    }


def run_drill(args, *, configs=model_configs, params_fn=make_params,
              keep=None) -> dict:
    """The reference run and the storm; returns the artifact.
    ``configs(args)`` gives the engines' ``(GptConfig, ServeConfig)``,
    ``params_fn(args, key, configs)`` the weights (key 1 serves, key 2 is
    the deploy).  ``keep`` (a dict) receives each run's requests and
    fleet under "reference"/"storm" and "reference_fleet"/"storm_fleet"."""
    from apex_tpu_torch.observability.spans import (
        SpanRecorder,
        wall_clock_anchor,
    )
    from apex_tpu_torch.resilience import chaos

    faults, seed = chaos.parse_spec(args.chaos)
    sites = sorted({f.site for f in faults})
    keep = {} if keep is None else keep
    params = params_fn(args, 1, configs)

    # -- 1. fault-free N-replica reference (same traffic, spike and all;
    # no chaos, no autoscaler, no deploy) ----------------------------------
    ref_clock = VirtualClock()
    ref_fleet = build_fleet(args, ref_clock, params, configs=configs)
    keep["reference_fleet"] = ref_fleet
    reference = run_fleet_load(ref_fleet, ref_clock, args,
                               label="reference",
                               keep=keep.setdefault("reference", []))
    ref_leaks = ref_fleet.leak_check()

    # -- 2. the storm: crash + preemption + spike + rolling deploy ---------
    recorder = SpanRecorder(capacity=args.span_capacity)
    storm_clock = VirtualClock()
    storm_fleet = build_fleet(args, storm_clock, params,
                              recorder=recorder, scaled=True,
                              configs=configs)
    keep["storm_fleet"] = storm_fleet
    deploy_params = params_fn(args, 2, configs)
    with chaos.inject(*faults, seed=seed):
        storm = run_fleet_load(
            storm_fleet, storm_clock, args, label="storm",
            deploy_params=deploy_params, tail_ticks=args.tail_ticks,
            keep=keep.setdefault("storm", []),
        )
    storm_leaks = storm_fleet.leak_check()
    ops = ops_check(storm_fleet)

    if args.spans:
        recorder.dump(reason="fleet_drill", path=args.spans)

    freg = {
        k: v for k, v in storm_fleet.registry.fetch().items()
        if k.startswith("fleet/")
    }
    agg_serve = storm_fleet.aggregate_values()

    ref_p99 = reference["ttft_ms"]["p99"]
    storm_p99 = storm["ttft_ms"]["p99"]
    inflation = (
        storm_p99 / ref_p99
        if ref_p99 and ref_p99 == ref_p99 and storm_p99 == storm_p99
        else float("nan")
    )
    health_rules = [e.rule for e in storm_fleet.health_events]

    return {
        "anchor": wall_clock_anchor(),
        "config": {
            k: getattr(args, k) for k in (
                "requests", "rate", "spike_factor", "spike_start",
                "spike_end", "prompt_mix", "output_mix", "seed",
                "replicas", "max_replicas", "batch", "page_size",
                "pages", "pages_per_seq", "max_queue_depth",
                "max_retries", "deploy_tick", "tail_ticks",
            )
        },
        "chaos_spec": args.chaos,
        "chaos_sites": sites,
        "reference": reference,
        "storm": storm,
        "p99_ttft_inflation": inflation,
        "process_deaths": 0,  # reaching this line IS the evidence
        "goodput": storm_fleet.goodput(),
        "terminals": {
            "offered": storm["offered"],
            "completed": storm["completed"],
            "shed": storm["shed"],
            "accounted": (
                storm["completed"] + storm["shed"] == storm["offered"]
            ),
            "open_spans": len(recorder.open_requests),
            "span_drops": recorder.dropped,
        },
        "pages": {
            "per_replica_in_use": storm_leaks,
            "reference_in_use": ref_leaks,
        },
        "fleet_registry": freg,
        "aggregated_serve": agg_serve,
        "replicas": storm_fleet.summary()["replicas"],
        "deploys": storm_fleet.deploy_history,
        "autoscaler": {
            "decisions": [
                e.rule for e in storm_fleet.autoscaler.decisions
            ],
            "health_events": health_rules,
            "scale_out_events": health_rules.count("fleet_scale_out"),
            "scale_in_events": health_rules.count("fleet_scale_in"),
        },
        "ops": ops,
        "spans_file": args.spans,
    }


def check(art, args) -> list:
    """The drill's acceptance claims, each failure as a message."""
    failures = []
    storm = art["storm"]
    fr = art["fleet_registry"]
    t = art["terminals"]
    if not t["accounted"]:
        failures.append(
            f"unaccounted terminals: {t['completed']}+{t['shed']} != "
            f"{t['offered']}"
        )
    if storm["unterminated"]:
        failures.append(f"unterminated requests: {storm['unterminated']}")
    if t["open_spans"]:
        failures.append(f"{t['open_spans']} request span chains left open")
    leaked = {k: v for k, v in art["pages"]["per_replica_in_use"].items()
              if v != 0}
    if leaked:
        failures.append(f"leaked pages on replicas: {leaked}")
    infl = art["p99_ttft_inflation"]
    if not (infl == infl and infl <= args.max_p99_inflation):
        failures.append(
            f"p99 TTFT inflation {infl:.2f}x over the "
            f"{args.max_p99_inflation:.1f}x bound"
        )
    if args.chaos == DEFAULT_CHAOS_SPEC:
        for key, want in DEFAULT_EXPECTED.items():
            if fr.get(key, 0) != want:
                failures.append(
                    f"{key}={fr.get(key, 0)} != injected {want} — a "
                    "fleet fault fired without its ledger entry (or "
                    "never fired at all)"
                )
    if fr.get("fleet/scale_out", 0) < 1:
        failures.append("autoscaler never scaled out under the storm")
    if fr.get("fleet/scale_in", 0) < 1:
        failures.append("autoscaler never scaled in after the storm")
    if art["autoscaler"]["scale_out_events"] < 1:
        failures.append("no fleet_scale_out health event on the timeline")
    if art["autoscaler"]["scale_in_events"] < 1:
        failures.append("no fleet_scale_in health event on the timeline")
    if not storm["deployed"] or not art["deploys"]:
        failures.append("the rolling update never ran to completion")
    for d in art["deploys"]:
        if d["lost_requests"] != 0:
            failures.append(
                f"rolling deploy lost {d['lost_requests']} accepted "
                f"requests to shed(draining)"
            )
        if not d["updated"]:
            failures.append("rolling deploy updated zero replicas")
    agg = art["aggregated_serve"]
    if agg.get("serve/shed_rerouted", 0) != fr.get("fleet/rerouted", 0):
        failures.append(
            f"re-route ledger split-brain: per-replica "
            f"serve/shed_rerouted sums to "
            f"{agg.get('serve/shed_rerouted', 0)} but the fleet "
            f"counted {fr.get('fleet/rerouted', 0)} re-admissions"
        )
    ops = art["ops"]
    if not ops["all_bound"] or not ops["distinct_ports"]:
        failures.append(
            f"ops servers not cleanly bound: ports={ops['ports']}"
        )
    if ops["aggregated_sources"] != ops["servers"]:
        failures.append(
            f"scrape aggregation saw {ops['aggregated_sources']} "
            f"sources for {ops['servers']} servers"
        )
    return failures


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=140)
    ap.add_argument("--rate", type=float, default=30.0,
                    help="base Poisson arrival rate, requests/s "
                    "(virtual time)")
    ap.add_argument("--spike-factor", type=float, default=5.0,
                    dest="spike_factor",
                    help="arrival-rate multiplier during the spike")
    ap.add_argument("--spike-start", type=float, default=0.9,
                    dest="spike_start", help="spike window start (s)")
    ap.add_argument("--spike-end", type=float, default=1.5,
                    dest="spike_end", help="spike window end (s)")
    ap.add_argument("--prompt-mix", type=int, nargs="+",
                    default=[8, 16, 24], dest="prompt_mix")
    ap.add_argument("--output-mix", type=int, nargs="+",
                    default=[8, 16, 24], dest="output_mix")
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=64)
    ap.add_argument("--pages-per-seq", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="run the build checks at every (re)build — "
                    "slower; redeploys re-verify too")
    ap.add_argument("--chaos", default=DEFAULT_CHAOS_SPEC,
                    help="APEX_TPU_CHAOS-grammar storm spec; fleet.* "
                    "site indices are FLEET TICKS (default fires all "
                    "three fleet sites)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="initial fleet size (and the reference size)")
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--max-queue-depth", type=int, default=16)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--clamp-max-new-tokens", type=int, default=12)
    ap.add_argument("--clamp-occupancy", type=float, default=0.85)
    ap.add_argument("--ttft-threshold-ms", type=float, default=100.0,
                    dest="ttft_threshold_ms")
    ap.add_argument("--out-factor", type=float, default=3.0,
                    dest="out_factor")
    ap.add_argument("--queue-high", type=float, default=8.0)
    ap.add_argument("--queue-low", type=float, default=1.0)
    ap.add_argument("--cooldown-ticks", type=int, default=32)
    ap.add_argument("--deploy-tick", type=int, default=320,
                    help="fleet tick to start the rolling update at "
                    "(mid-load, right after the spike)")
    ap.add_argument("--tail-ticks", type=int, default=400,
                    help="idle ticks after the load settles (the "
                    "scale-in headroom window)")
    ap.add_argument("--max-ticks", type=int, default=20000)
    ap.add_argument("--max-p99-inflation", type=float, default=2.0)
    ap.add_argument("--json", default=None, metavar="OUT")
    ap.add_argument("--spans", default=None, metavar="OUT")
    ap.add_argument("--span-capacity", type=int, default=65536)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from apex_tpu_torch.ops._dispatch import resolve_device

    resolve_device(args.device)  # the card unless asked otherwise
    art = run_drill(args)
    if args.json:
        from apex_tpu_torch.observability.flight import json_safe

        with open(args.json, "w") as f:
            json.dump(json_safe(art), f, indent=1, allow_nan=False)
            f.write("\n")

    ref, storm = art["reference"], art["storm"]
    print(
        "fleet drill: storm %d/%d completed (%d shed: %s) across "
        "%d replicas; reference %d/%d on %d"
        % (storm["completed"], storm["offered"], storm["shed"],
           ", ".join(f"{k}={v}"
                     for k, v in sorted(storm["shed_reasons"].items()))
           or "none",
           len(art["replicas"]), ref["completed"], ref["offered"],
           art["config"]["replicas"])
    )
    print(
        "  p99 TTFT: storm %.2fms vs reference %.2fms (inflation "
        "%.2fx, bound %.1fx)"
        % (storm["ttft_ms"]["p99"], ref["ttft_ms"]["p99"],
           art["p99_ttft_inflation"], args.max_p99_inflation)
    )
    fr = art["fleet_registry"]
    print(
        "  churn: crashes=%d preempts=%d router_faults=%d "
        "rerouted=%d scale_out=%d scale_in=%d deploys=%d"
        % (fr.get("fleet/replica_crashes", 0),
           fr.get("fleet/preempts", 0),
           fr.get("fleet/router_faults", 0),
           fr.get("fleet/rerouted", 0),
           fr.get("fleet/scale_out", 0),
           fr.get("fleet/scale_in", 0),
           fr.get("fleet/deploys", 0))
    )
    for d in art["deploys"]:
        print(
            "  deploy: ticks %d..%d updated=%s lost_requests=%d"
            % (d["started_tick"], d["finished_tick"],
               ",".join(d["updated"]), d["lost_requests"])
        )
    print(
        "  ops: %d servers on ports %s, %d counter families aggregated"
        % (art["ops"]["servers"], art["ops"]["ports"],
           art["ops"]["counter_families"])
    )
    print("  ledgers: reference %s storm %s"
          % (ref["ledger_digest"], storm["ledger_digest"]))
    failures = check(art, args)
    for msg in failures:
        print(f"FLEET DRILL FAIL: {msg}", file=sys.stderr)
    if not failures:
        print("fleet drill: PASS")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
