"""Serving chaos drill — the serving resilience layer end to end.

Counterpart of ``tools/serve_chaos_drill.py``.  A Poisson load runs
twice through the real engine and continuous-batching scheduler — once
fault-free (the reference), once under a storm at the four serving
chaos sites (``serve.prefill``, ``serve.decode``, ``serve.admission``,
``serve.kv_alloc``) — and the drill holds the four guarantees:

1. **no process death** — every fault is absorbed by bounded retries,
   the quarantine of poisoned requests and the supervised engine
   rebuild (a re-capture of the CUDA graphs on the card);
2. **no leaked page** — ``PagePool.leak_check`` runs after every shed
   and free path, and the pool ends empty;
3. **one terminal per request** — completed + shed equals offered, and
   no request span chain is left open;
4. **bounded p99 TTFT inflation** — the storm's p99 TTFT within
   ``--max-p99-inflation`` (2x) of the fault-free run's.  Both loads run
   on a :class:`VirtualClock` (one tick a loop iteration), so TTFT
   measures scheduling delay in ticks, reproducibly per seed.

An **overload probe** then walks the degradation ladder (a burst of 3 x
the queue cap: exactly the excess is shed as ``queue_full``, admissions
are clamped), and a **drain phase** stops admission mid-flight on the
storm-scarred scheduler: running decodes finish, the queue is shed as
``draining`` and the pool is proven empty.  The arrivals and prompts
are drawn by numpy from ``--seed`` exactly as the reference drill draws
them, so the two drills' ledgers can be compared.

Usage (the card by default; ``--device cpu`` runs the plain versions)::

    python -m apex_tpu_torch.tools.serve_chaos_drill --json OUT.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the default storm: every serving chaos site fires at least once.
#: Indices are 0-based call counters per site (prefill calls, decode
#: iterations, admission attempts, pool allocations).  No stall: an
#: injected hang would dwarf the fault-free p99 (the decode-timeout rung
#: is held by the unit tests instead).
DEFAULT_CHAOS_SPEC = (
    "serve.prefill:raise:x1@2;"
    "serve.decode:raise:x1@6;"
    "serve.decode:nan:x2@10,16;"
    "serve.admission:raise:x2@4,5;"
    "serve.kv_alloc:fail:x2@9,12"
)

#: the ledger counts DEFAULT_CHAOS_SPEC must produce
DEFAULT_EXPECTED = {
    "engine_faults": 2,      # 1 prefill raise + 1 decode raise
    "engine_rebuilds": 1,    # decode raise -> supervised rebuild
    "poisoned": 2,           # 2 nan decode iterations, 1 slot each
    "admission_faults": 2,
    "kv_alloc_faults": 2,
}

#: the artifact's registry keys that DEFAULT_EXPECTED pins
EXPECTED_KEYS = {
    "engine_faults": "serve/engine_faults",
    "engine_rebuilds": "serve/engine_rebuilds",
    "poisoned": "serve/shed_poisoned",
    "admission_faults": "serve/admission_faults",
    "kv_alloc_faults": "serve/kv_alloc_faults",
}


def build_engine(args, *, registry=None):
    """The drill's engine: an f32 GPT of the parser's widths (seeded
    random weights) behind an
    :class:`~apex_tpu_torch.serve.InferenceEngine` on ``--device``,
    built (its decode step captured on the card)."""
    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = GptConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.heads,
        intermediate_size=2 * args.hidden, max_seq_len=256,
        dtype=torch.float32,
    )
    serve_cfg = ServeConfig(
        page_size=args.page_size, num_pages=args.pages,
        max_batch=args.batch, max_pages_per_seq=args.pages_per_seq,
    )
    gen = torch.Generator(args.device).manual_seed(1)
    model = GptModel(cfg, device=args.device, generator=gen)
    return InferenceEngine(cfg, model, serve_cfg, registry=registry,
                           device=args.device).build()


class VirtualClock:
    """A deterministic scheduler clock: one fixed tick per drill loop
    iteration, so TTFT measures scheduling delay (queue wait, retry round
    trips, fault recovery) in iteration units, reproducibly per seed."""

    def __init__(self, tick_s: float = 0.005):
        self.t = 0.0
        self.tick_s = tick_s

    def __call__(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.tick_s


def run_load(sched, clock, args, *, label, keep=None):
    """One Poisson load on the virtual clock: arrivals and lengths drawn
    from ``--seed`` as the reference drill draws them.  ``keep`` (a list)
    receives the requests."""
    from apex_tpu_torch.observability.meter import percentile
    from apex_tpu_torch.serve import Request

    rs = np.random.RandomState(args.seed)
    gaps = rs.exponential(1.0 / args.rate, size=args.requests)
    arrivals = np.cumsum(gaps)
    prompt_lens = rs.choice(args.prompt_mix, size=args.requests)
    out_lens = rs.choice(args.output_mix, size=args.requests)

    submitted = 0
    reqs = []
    t0 = time.perf_counter()
    while submitted < args.requests or sched.pending:
        now = clock()
        while submitted < args.requests and arrivals[submitted] <= now:
            reqs.append(sched.submit(Request(
                prompt=[int(t) for t in rs.randint(
                    0, args.vocab, size=prompt_lens[submitted])],
                max_new_tokens=int(out_lens[submitted]),
            )))
            submitted += 1
        if sched.pending:
            sched.step()
        clock.advance()
    host_s = time.perf_counter() - t0
    if keep is not None:
        keep.extend(reqs)

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
        "unterminated": [r.rid for r in reqs
                         if r.status not in ("done", "shed")],
        "retries_total": sum(r.retries for r in reqs),
        "clamped": sum(1 for r in reqs if r.clamped_from is not None),
        "ttft_ms": {
            "p50": percentile(ttfts, 0.50),
            "p99": percentile(ttfts, 0.99),
            "samples": len(ttfts),
        },
        "wall_s": clock(),
        "host_s": host_s,
    }


def run_drill(args, *, engine_factory=build_engine, keep=None) -> dict:
    """The drill's four phases; returns the artifact.  ``engine_factory
    (args, registry=...)`` builds each run's engine.  ``keep`` (a dict)
    receives the reference and storm runs' requests under "reference"
    and "storm"."""
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.observability.spans import (
        SpanRecorder,
        wall_clock_anchor,
    )
    from apex_tpu_torch.resilience import chaos
    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    faults, seed = chaos.parse_spec(args.chaos)
    sites = sorted({f.site for f in faults})
    keep = {} if keep is None else keep

    # -- 1. fault-free reference ------------------------------------------
    ref_engine = engine_factory(args)
    ref_clock = VirtualClock()
    ref_sched = ContinuousBatchingScheduler(
        ref_engine, registry=None, clock=ref_clock,
        max_queue_depth=args.max_queue_depth,
        clamp_max_new_tokens=args.clamp_max_new_tokens,
        clamp_occupancy=args.clamp_occupancy,
    )
    reference = run_load(ref_sched, ref_clock, args, label="reference",
                         keep=keep.setdefault("reference", []))
    ref_sched.leak_check()

    # -- 2. the chaos storm ------------------------------------------------
    recorder = (SpanRecorder(capacity=args.span_capacity)
                if args.spans else None)
    registry = MetricRegistry(fetch_every=1)
    storm_engine = engine_factory(args, registry=registry)
    storm_clock = VirtualClock()
    storm_sched = ContinuousBatchingScheduler(
        storm_engine, registry=registry, spans=recorder, clock=storm_clock,
        max_queue_depth=args.max_queue_depth,
        clamp_max_new_tokens=args.clamp_max_new_tokens,
        clamp_occupancy=args.clamp_occupancy,
    )
    with chaos.inject(*faults, seed=seed):
        storm = run_load(storm_sched, storm_clock, args, label="storm",
                         keep=keep.setdefault("storm", []))
    storm_sched.leak_check()

    # -- 3. the overload probe: the degradation ladder ---------------------
    # a synchronous burst against a small queue cap: exactly (burst - cap)
    # submissions must be rejected at rung 1, and admissions under the
    # backed-up queue clamped at rung 2
    probe_cap = 4
    probe_clamp = 4
    probe_sched = ContinuousBatchingScheduler(
        storm_engine, registry=registry, spans=recorder, clock=storm_clock,
        max_queue_depth=probe_cap,
        clamp_max_new_tokens=probe_clamp,
        clamp_queue_depth=2,
    )
    rs = np.random.RandomState(args.seed + 7)
    burst = [
        probe_sched.submit(Request(
            prompt=[int(t) for t in rs.randint(0, args.vocab,
                                               size=args.prompt_mix[0])],
            max_new_tokens=16,
        ))
        for _ in range(3 * probe_cap)
    ]
    probe_sched.run()
    probe = {
        "burst": len(burst),
        "queue_cap": probe_cap,
        "queue_full": sum(1 for r in burst if r.shed_reason == "queue_full"),
        "clamped": sum(1 for r in burst if r.clamped_from is not None),
        "clamped_to": sorted({r.max_new_tokens for r in burst
                              if r.clamped_from is not None}),
        "completed": sum(1 for r in burst if r.status == "done"),
        "unterminated": [r.rid for r in burst
                         if r.status not in ("done", "shed")],
    }
    probe_sched.leak_check()

    # -- 4. graceful drain on the storm-scarred scheduler ------------------
    rs = np.random.RandomState(args.seed + 1)
    drain_reqs = [
        storm_sched.submit(Request(
            prompt=[int(t) for t in rs.randint(0, args.vocab,
                                               size=args.prompt_mix[0])],
            max_new_tokens=8,
        ))
        for _ in range(args.drain_requests)
    ]
    storm_sched.step()
    drain_report = storm_sched.drain()
    drain_statuses = {}
    for r in drain_reqs:
        drain_statuses[r.status] = drain_statuses.get(r.status, 0) + 1

    if recorder is not None:
        recorder.dump(reason="serve_chaos_drill", path=args.spans)

    registry.fetch()
    reg = {k: v for k, v in registry.values().items()
           if k.startswith("serve/")}

    ref_p99 = reference["ttft_ms"]["p99"]
    storm_p99 = storm["ttft_ms"]["p99"]
    inflation = (
        storm_p99 / ref_p99
        if ref_p99 and ref_p99 == ref_p99 and storm_p99 == storm_p99
        else float("nan")
    )
    offered_total = storm["offered"] + probe["burst"] + len(drain_reqs)
    done_total = len(storm_sched.completed) + len(probe_sched.completed)
    shed_total = len(storm_sched.shed) + len(probe_sched.shed)

    return {
        "anchor": wall_clock_anchor(),
        "config": {
            k: getattr(args, k) for k in (
                "requests", "rate", "prompt_mix", "output_mix", "seed",
                "batch", "page_size", "pages", "pages_per_seq",
                "max_queue_depth", "clamp_max_new_tokens",
                "drain_requests",
            )
        },
        "chaos_spec": args.chaos,
        "chaos_sites": sites,
        "reference": reference,
        "storm": storm,
        "overload_probe": probe,
        "p99_ttft_inflation": inflation,
        "process_deaths": 0,  # reaching this line is the evidence
        "terminals": {
            "offered": offered_total,
            "completed": done_total,
            "shed": shed_total,
            "accounted": done_total + shed_total == offered_total,
            "open_spans": (len(recorder.open_requests)
                           if recorder is not None else None),
        },
        "pages": {
            "pool_in_use_end": storm_sched.pool.in_use,
            "leak_checks_run": storm_sched.leak_checks_run,
        },
        "engine": {
            "rebuilds": storm_engine.rebuilds,
            "graph_captures": dict(storm_engine.captures),
        },
        "registry": reg,
        "drain": {
            **drain_report,
            "statuses": drain_statuses,
            "shed_draining": sum(1 for r in drain_reqs
                                 if r.shed_reason == "draining"),
        },
        "spans_file": args.spans,
    }


def check(art, args) -> list:
    """The drill's failures (empty when it passes): the four guarantees,
    the ledger pins of the default storm, and the ladder and drain."""
    failures = []
    storm, probe = art["storm"], art["overload_probe"]
    t = art["terminals"]
    if not t["accounted"]:
        failures.append(f"unaccounted terminals: {t['completed']}+"
                        f"{t['shed']} != {t['offered']}")
    if t["open_spans"]:
        failures.append(f"{t['open_spans']} request span chains left open")
    if storm["unterminated"]:
        failures.append(f"unterminated requests: {storm['unterminated']}")
    if art["pages"]["pool_in_use_end"] != 0:
        failures.append(
            f"leaked pages: pool in_use={art['pages']['pool_in_use_end']}")
    infl = art["p99_ttft_inflation"]
    if not (infl == infl and infl <= args.max_p99_inflation):
        failures.append(f"p99 TTFT inflation {infl:.2f}x over the "
                        f"{args.max_p99_inflation:.1f}x bound")
    if args.chaos == DEFAULT_CHAOS_SPEC:
        reg = art["registry"]
        for name, key in EXPECTED_KEYS.items():
            if reg.get(key, 0) != DEFAULT_EXPECTED[name]:
                failures.append(
                    f"{key}={reg.get(key, 0)} != injected "
                    f"{DEFAULT_EXPECTED[name]}: a fault fired without its "
                    "ledger entry, never fired, or a fault that was not "
                    "injected was absorbed")
        if reg.get("serve/retries", 0) < 1:
            failures.append("no re-admission retries under the storm")
    want_rejects = probe["burst"] - probe["queue_cap"]
    if probe["queue_full"] != want_rejects:
        failures.append(f"backpressure rung: {probe['queue_full']} "
                        f"queue_full rejects != the over-cap excess "
                        f"{want_rejects}")
    if probe["clamped"] < 2:
        failures.append(f"clamp rung: only {probe['clamped']} admissions "
                        "clamped under a backed-up queue")
    if probe["unterminated"]:
        failures.append("overload probe left unterminated requests: "
                        f"{probe['unterminated']}")
    if not art["drain"]["drained"] or art["drain"]["pool_in_use"] != 0:
        failures.append(f"drain not clean: {art['drain']}")
    if (art["config"]["drain_requests"] > art["config"]["batch"]
            and art["drain"]["shed_draining"] == 0):
        failures.append("drain shed no queued request as 'draining'")
    return failures


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=30.0,
                    help="Poisson arrival rate, requests/s of virtual time")
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
    ap.add_argument("--chaos", default=DEFAULT_CHAOS_SPEC,
                    help="APEX_TPU_CHAOS-grammar storm spec (the default "
                    "fires all four serve sites)")
    ap.add_argument("--max-queue-depth", type=int, default=12)
    ap.add_argument("--clamp-max-new-tokens", type=int, default=12)
    ap.add_argument("--clamp-occupancy", type=float, default=0.6)
    ap.add_argument("--drain-requests", type=int, default=6)
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
    reg = art["registry"]
    print("serve chaos drill: storm %d/%d completed (%d shed: %s), "
          "reference %d/%d" % (
              storm["completed"], storm["offered"], storm["shed"],
              ", ".join(f"{k}={v}" for k, v in
                        sorted(storm["shed_reasons"].items())) or "none",
              ref["completed"], ref["offered"]))
    print("  p99 TTFT: storm %.2fms vs reference %.2fms (inflation %.2fx, "
          "bound %.1fx)" % (storm["ttft_ms"]["p99"], ref["ttft_ms"]["p99"],
                            art["p99_ttft_inflation"],
                            args.max_p99_inflation))
    print("  recovery: rebuilds=%d retries=%d readmitted=%d timeouts=%d "
          "clamped=%d; pages: in_use=%d leak_checks=%d" % (
              art["engine"]["rebuilds"], reg.get("serve/retries", 0),
              reg.get("serve/readmitted", 0),
              reg.get("serve/decode_timeouts", 0),
              reg.get("serve/clamped", 0), art["pages"]["pool_in_use_end"],
              art["pages"]["leak_checks_run"]))
    probe = art["overload_probe"]
    print("  ladder probe: burst=%d cap=%d -> queue_full=%d clamped=%d "
          "completed=%d" % (probe["burst"], probe["queue_cap"],
                            probe["queue_full"], probe["clamped"],
                            probe["completed"]))
    print("  drain: %s (shed_draining=%d)" % (
        art["drain"]["statuses"], art["drain"]["shed_draining"]))
    failures = check(art, args)
    for msg in failures:
        print(f"SERVE CHAOS DRILL FAIL: {msg}", file=sys.stderr)
    if not failures:
        print("serve chaos drill: PASS")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
