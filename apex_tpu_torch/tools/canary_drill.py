"""Canary-gated deploy drill — the canary acceptance gate.

Counterpart of ``tools/canary_drill.py``.  Three scenarios in one seeded
run on a deterministic virtual clock:

1. **fingerprint identity** — a golden-probe fingerprint survives
   ``engine.rebuild(full=True)`` bit for bit, a SINGLE flipped sign bit
   on the highest-magnitude weight flips the digest, and restoring the
   weights restores it;
2. **clean deploys, zero false verdicts** — across ``--clean-seeds``
   seeded loads, a canary-gated deploy of re-initialized weights PASSES
   every time: no fail verdict, no rollback, zero lost requests, every
   live replica on the new weights, router exposure within
   ``canary_frac``;
3. **planted regression detected + rolled back** — the deploy ships
   NaN-poisoned weights on a replica whose decode is throttled while it
   serves them (it runs 1 of every ``--slow-factor`` fleet ticks).  The
   drift verdict FAILS inside the window, the deploy halts, the canary
   is rebuilt onto the incumbent weights (its fingerprint bit for bit
   the pre-deploy digest), ``fleet/deploys_rolled_back`` bumps, zero
   requests are lost, and the bad weights' exposure — routed requests
   and served tokens — stays within the canary fraction.

A fleet's engines share one prepared copy of the weights, as the
reference's share one parameter tree; a redeploy gives a replica weights
of its own, and the incumbents keep theirs (every live replica's
fingerprint after the rollback is the incumbent's).

Usage (the card by default; ``--device cpu`` runs the plain versions)::

    python -m apex_tpu_torch.tools.canary_drill --json OUT.json \\
        --spans SPANS.json
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from apex_tpu_torch.tools import fleet_drill

VirtualClock = fleet_drill.VirtualClock
model_configs = fleet_drill.model_configs
make_params = fleet_drill.make_params


@torch.no_grad()
def corrupt_one_bit(params):
    """A copy of the model with the SIGN bit of its single
    highest-magnitude weight flipped — one bit, where it provably takes
    part in every forward pass."""
    import copy

    out = copy.deepcopy(params)
    best = max(out.parameters(), key=lambda p: float(p.abs().max()))
    flat = best.data.view(-1)
    j = int(flat.abs().argmax())
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[flat.dtype]
    sign = torch.iinfo(bits).min  # the sign bit alone
    word = flat[j:j + 1].view(bits)
    word.copy_(word ^ sign)
    return out


@torch.no_grad()
def nan_poison(params):
    """The planted regression: a copy with every weight tensor set to NaN
    — the corrupted-checkpoint deploy the canary gate must catch."""
    import copy

    out = copy.deepcopy(params)
    for p in out.parameters():
        if p.dim():
            p.fill_(float("nan"))
    return out


def _throttled_replica_cls():
    from apex_tpu_torch.fleetctl import EngineReplica

    class _Throttled(EngineReplica):
        """A replica whose scheduler runs 1 of every ``slow_factor``
        fleet ticks WHILE it serves the regressed weights — the
        deterministic stand-in for a slow new build on the new replica
        only (weights alone cannot move virtual-clock latency)."""

        def __init__(self, *a, regressed=None, slow_factor=3, **kw):
            super().__init__(*a, **kw)
            self._regressed = regressed
            self._slow = int(slow_factor)
            self._throttled = False
            self._phase = 0

        def redeploy(self, params, draft_params=None):
            super().redeploy(params, draft_params)
            self._throttled = params is self._regressed
            self._phase = 0

        def step(self):
            if self._throttled:
                self._phase = (self._phase + 1) % self._slow
                if self._phase != 0:
                    return
            super().step()

    return _Throttled


def build_canary_fleet(args, clock, params, *, recorder=None,
                       regressed=None, configs=model_configs):
    """A fixed-size fleet (no autoscaler: the canary hold's routing
    arithmetic is the subject under test) whose replicas throttle
    themselves iff handed the ``regressed`` weights."""
    from apex_tpu_torch.fleetctl import Fleet
    from apex_tpu_torch.observability import MetricRegistry

    cls = _throttled_replica_cls()
    build = fleet_drill.engine_factory(args, params, configs)

    def factory(name: str):
        return cls(
            name, build(MetricRegistry(fetch_every=1)), clock=clock,
            spans=recorder, regressed=regressed,
            slow_factor=args.slow_factor,
            max_queue_depth=args.max_queue_depth,
            max_retries=args.max_retries,
        )

    return Fleet(factory, replicas=args.replicas, clock=clock,
                 spans=recorder)


def canary_config(args, probes):
    from apex_tpu_torch.observability.canary import CanaryConfig

    return CanaryConfig(
        frac=args.canary_frac, probes=probes,
        min_samples=args.min_samples, alpha=args.alpha,
        min_events=args.min_events,
        min_event_total=args.min_event_total,
        soak_ticks=args.soak_ticks,
        max_window_ticks=args.max_window_ticks,
    )


def _probes(args):
    from apex_tpu_torch.observability.canary import GoldenProbeSet

    return GoldenProbeSet.generate(
        args.vocab, n_probes=args.n_probes,
        prompt_len=args.probe_prompt_len,
        max_new_tokens=args.probe_new_tokens, seed=args.probe_seed,
    )


def run_canary_load(fleet, clock, args, *, label, deploy_params,
                    canary_cfg, seed, keep=None):
    """One seeded Poisson load with a canary-gated deploy at
    ``--deploy-tick``; runs until every request is terminal AND the
    deploy machinery is idle.  ``keep`` (a list) receives the
    requests."""
    import numpy as np

    from apex_tpu_torch.observability.meter import percentile
    from apex_tpu_torch.serve import Request

    rs = np.random.RandomState(seed)
    t0 = clock()
    arrivals = [t0 + a for a in fleet_drill.gen_arrivals(args, rs)]
    prompt_lens = rs.choice(args.prompt_mix, size=args.requests)
    out_lens = rs.choice(args.output_mix, size=args.requests)

    start_tick = fleet.tick
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
            not deployed
            and fleet.tick - start_tick >= args.deploy_tick
        ):
            fleet.start_rolling_update(deploy_params, canary=canary_cfg)
            deployed = True
        fleet.step()
        clock.advance()
        if submitted >= args.requests and deployed and not fleet.pending:
            idle += 1
            if idle >= args.tail_ticks:
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
    freg = {
        k: v for k, v in fleet.registry.fetch().items()
        if k.startswith("fleet/")
    }
    return {
        "label": label,
        "seed": seed,
        "offered": len(reqs),
        "completed": len(done),
        "shed": len(shed),
        "shed_reasons": shed_reasons,
        "unterminated": [
            r.rid for r in reqs if r.status not in ("done", "shed")
        ],
        "ttft_p99_ms": percentile(ttfts, 0.99) if ttfts else None,
        "ticks": fleet.tick - start_tick,
        "deploys": fleet.deploy_history,
        "rolled_back": freg.get("fleet/deploys_rolled_back", 0.0),
        "verdict_pass": freg.get("fleet/canary/verdict_pass", 0.0),
        "verdict_fail": freg.get("fleet/canary/verdict_fail", 0.0),
        "probes": freg.get("fleet/canary/probes", 0.0),
        "fleet_registry": freg,
        "leaks": fleet.leak_check(),
        "health_rules": [e.rule for e in fleet.health_events],
        "ledger_digest": fleet_drill.ledger_digest(
            fleet_drill.ledger(reqs, clock.tick_s)),
    }


def fingerprint_scenario(args, *, configs=model_configs,
                         params_fn=make_params, keep=None) -> dict:
    """Scenario 1: rebuild bit-exactness, single-bit sensitivity,
    restore symmetry — on one quiet engine (``keep["fingerprint_engine"]``
    when ``keep`` is given)."""
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.observability.canary import (
        fingerprint_distance,
        model_fingerprint,
    )

    params = params_fn(args, 1, configs)
    engine = fleet_drill.engine_factory(args, params, configs)(
        MetricRegistry(fetch_every=1))
    if keep is not None:
        keep["fingerprint_engine"] = engine
    probes = _probes(args)
    fp_a = model_fingerprint(engine, probes)
    engine.rebuild(full=True)
    fp_b = model_fingerprint(engine, probes)
    engine.swap_weights(corrupt_one_bit(params))
    fp_bit = model_fingerprint(engine, probes)
    engine.swap_weights(params)
    fp_back = model_fingerprint(engine, probes)
    pool_clean = engine.pool.in_use == 0
    return {
        "digest": fp_a["digest"],
        "rebuild_bit_exact": fp_a["digest"] == fp_b["digest"],
        "single_bit_flips_digest": fp_a["digest"] != fp_bit["digest"],
        "single_bit_distance": fingerprint_distance(fp_a, fp_bit),
        "restore_matches": fp_back["digest"] == fp_a["digest"],
        "probe_pool_clean": pool_clean,
        "probe_tokens": fp_a["tokens"],
    }


def run_drill(args, *, configs=model_configs, params_fn=make_params,
              keep=None) -> dict:
    """The three scenarios; returns the artifact.  ``configs`` and
    ``params_fn`` as :func:`apex_tpu_torch.tools.fleet_drill.run_drill`'s
    (key 1 serves, keys 10.. are the clean deploys, key 2 the regressed
    one).  ``keep`` (a dict) receives every run's fleet (``"fleet:"`` and
    the run's label), every run's requests (by label) and the
    fingerprint scenario's engine."""
    from apex_tpu_torch.observability.spans import (
        SpanRecorder,
        wall_clock_anchor,
    )

    keep = {} if keep is None else keep
    probes = _probes(args)
    fingerprints = fingerprint_scenario(args, configs=configs,
                                        params_fn=params_fn, keep=keep)

    # one clock + one recorder across the recorded runs: time advances
    # monotonically through BOTH deploy windows, so the dump's windows
    # never overlap
    clock = VirtualClock()
    recorder = SpanRecorder(capacity=args.span_capacity, clock=clock)
    params = params_fn(args, 1, configs)

    # -- scenario 2: clean deploys across seeds ----------------------------
    clean_runs = []
    for i in range(args.clean_seeds):
        rec = recorder if i == 0 else None
        run_clock = clock if i == 0 else VirtualClock()
        fleet = build_canary_fleet(args, run_clock, params, recorder=rec,
                                   configs=configs)
        new_params = params_fn(args, 10 + i, configs)
        label = f"clean[{i}]"
        keep[f"fleet:{label}"] = fleet
        clean_runs.append(run_canary_load(
            fleet, run_clock, args, label=label,
            deploy_params=new_params,
            canary_cfg=canary_config(args, probes),
            seed=args.seed + i, keep=keep.setdefault(label, []),
        ))
        # every live replica ends on the new weights: the canary's
        # post-deploy fingerprint
        want = clean_runs[-1]["deploys"][-1]["canary"].get(
            "fingerprint", {}).get("new_digest") \
            if clean_runs[-1]["deploys"] else None
        digests = {}
        for rep in fleet.replicas:
            if rep.state == "live":
                rep.engine.reset_cache()
                digests[rep.name] = rep.probe(probes)["digest"]
        clean_runs[-1]["post_deploy_digests"] = digests
        clean_runs[-1]["canary_new_digest"] = want

    # -- scenario 3: the planted regression --------------------------------
    regressed = nan_poison(params_fn(args, 2, configs))
    fleet = build_canary_fleet(args, clock, params, recorder=recorder,
                               regressed=regressed, configs=configs)
    keep["fleet:regression"] = fleet
    incumbent_fp = fleet.replicas[0].probe(probes)
    regression = run_canary_load(
        fleet, clock, args, label="regression",
        deploy_params=regressed,
        canary_cfg=canary_config(args, probes),
        seed=args.seed + 100, keep=keep.setdefault("regression", []),
    )
    regression["incumbent_digest"] = incumbent_fp["digest"]
    # post-rollback: every live replica must hold weights that
    # fingerprint identical to the incumbent digest
    post_digests = {}
    for rep in fleet.replicas:
        if rep.state == "live":
            rep.engine.reset_cache()
            post_digests[rep.name] = rep.probe(probes)["digest"]
    regression["post_rollback_digests"] = post_digests

    if args.spans:
        recorder.dump(reason="canary_drill", path=args.spans)

    false_positives = sum(int(r["verdict_fail"]) for r in clean_runs)
    reg_deploy = regression["deploys"][-1] if regression["deploys"] \
        else {}
    reg_canary = reg_deploy.get("canary", {})
    detect_ticks = reg_canary.get("detect_ticks")

    return {
        "anchor": wall_clock_anchor(),
        "config": {
            k: getattr(args, k) for k in (
                "requests", "rate", "prompt_mix", "output_mix", "seed",
                "replicas", "batch", "page_size", "pages",
                "pages_per_seq", "max_queue_depth", "max_retries",
                "deploy_tick", "tail_ticks", "clean_seeds",
                "canary_frac", "min_samples", "alpha", "min_events",
                "min_event_total", "soak_ticks", "max_window_ticks",
                "slow_factor", "n_probes", "probe_prompt_len",
                "probe_new_tokens", "probe_seed",
            )
        },
        "fingerprints": fingerprints,
        "clean_runs": clean_runs,
        "regression": regression,
        "false_positives": false_positives,
        "detect_ticks": detect_ticks,
        "open_spans": len(recorder.open_requests),
        "span_drops": recorder.dropped,
        "spans_file": args.spans,
    }


def check(args, art) -> list:
    """The drill's own verdict: every acceptance claim as an explicit
    failure string."""
    failures = []
    fp = art["fingerprints"]
    if not fp["rebuild_bit_exact"]:
        failures.append("fingerprint changed across a same-weights "
                        "rebuild — bit-exactness broken")
    if not fp["single_bit_flips_digest"]:
        failures.append("a single-bit weight corruption did NOT flip "
                        "the fingerprint digest")
    if not fp["restore_matches"]:
        failures.append("restoring the weights did not restore the "
                        "fingerprint")
    if not fp["probe_pool_clean"]:
        failures.append("probing leaked pages")

    if art["false_positives"]:
        failures.append(
            f"{art['false_positives']} FALSE canary fail verdicts "
            f"across {len(art['clean_runs'])} clean deploys"
        )
    for run in art["clean_runs"]:
        label = run["label"]
        deploys = run["deploys"]
        if not deploys or deploys[-1].get("rolled_back"):
            failures.append(f"{label}: clean deploy did not complete")
            continue
        d = deploys[-1]
        if d["canary"].get("verdict") != "pass":
            failures.append(
                f"{label}: clean verdict "
                f"{d['canary'].get('verdict')!r} != 'pass'"
            )
        if d["lost_requests"] != 0:
            failures.append(
                f"{label}: lost {d['lost_requests']} requests"
            )
        if run["unterminated"]:
            failures.append(
                f"{label}: unterminated {run['unterminated']}"
            )
        exposure = d["canary"].get("exposure_frac", 1.0)
        routed = d["canary"].get("routed", 0)
        if routed and d["canary"]["canary_routed"] > \
                args.canary_frac * routed + 1:
            failures.append(
                f"{label}: routed exposure {exposure:.3f} broke the "
                f"{args.canary_frac} canary fraction bound"
            )
        if any(v != 0 for v in run["leaks"].values()):
            failures.append(f"{label}: leaked pages {run['leaks']}")
        want = run.get("canary_new_digest")
        for name, digest in run.get("post_deploy_digests", {}).items():
            if want is not None and digest != want:
                failures.append(
                    f"{label}: replica {name} fingerprints {digest[:12]} "
                    f"!= the canary's new weights {want[:12]}"
                )

    reg = art["regression"]
    deploys = reg["deploys"]
    if not deploys or not deploys[-1].get("rolled_back"):
        failures.append("planted regression was NOT rolled back")
        return failures
    d = deploys[-1]
    c = d["canary"]
    if c.get("verdict") != "fail":
        failures.append(
            f"regression verdict {c.get('verdict')!r} != 'fail'"
        )
    if reg["rolled_back"] != 1:
        failures.append(
            f"fleet/deploys_rolled_back={reg['rolled_back']} != 1"
        )
    if art["detect_ticks"] is None:
        failures.append("no detect_ticks recorded for the regression")
    if d["lost_requests"] != 0:
        failures.append(
            f"regression rollback lost {d['lost_requests']} requests"
        )
    if reg["unterminated"]:
        failures.append(
            f"regression: unterminated {reg['unterminated']}"
        )
    if c.get("fingerprint", {}).get("new_finite", True):
        failures.append(
            "NaN-poisoned weights fingerprinted as finite"
        )
    if c.get("rollback_digest") != reg["incumbent_digest"]:
        failures.append(
            "rollback fingerprint does not match the incumbent "
            "digest — the rollback is not bit-exact"
        )
    for name, digest in reg["post_rollback_digests"].items():
        if digest != reg["incumbent_digest"]:
            failures.append(
                f"replica {name} fingerprints {digest[:12]} != "
                f"incumbent after the rollback"
            )
    routed = c.get("routed", 0)
    if routed and c.get("canary_routed", 0) > \
            args.canary_frac * routed + 1:
        failures.append(
            f"regression routed exposure {c.get('exposure_frac')}"
            f" broke the {args.canary_frac} bound"
        )
    tok_total = c.get("tokens_total", 0)
    if tok_total and c.get("tokens_canary", 0) > \
            args.canary_frac * tok_total + args.batch * 4:
        failures.append(
            f"bad-weight TOKEN exposure {c.get('tokens_canary')}/"
            f"{tok_total} broke the {args.canary_frac} bound"
        )
    if any(v != 0 for v in reg["leaks"].values()):
        failures.append(f"regression: leaked pages {reg['leaks']}")
    if art["open_spans"]:
        failures.append(
            f"{art['open_spans']} request span chains left open"
        )
    return failures


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=220)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="Poisson arrival rate, requests/s (virtual)")
    ap.add_argument("--spike-factor", type=float, default=1.0,
                    dest="spike_factor")
    ap.add_argument("--spike-start", type=float, default=0.0,
                    dest="spike_start")
    ap.add_argument("--spike-end", type=float, default=0.0,
                    dest="spike_end")
    ap.add_argument("--prompt-mix", type=int, nargs="+",
                    default=[8, 16, 24], dest="prompt_mix")
    ap.add_argument("--output-mix", type=int, nargs="+",
                    default=[8, 16], dest="output_mix")
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=64)
    ap.add_argument("--pages-per-seq", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--max-queue-depth", type=int, default=16)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--deploy-tick", type=int, default=120)
    ap.add_argument("--tail-ticks", type=int, default=20)
    ap.add_argument("--max-ticks", type=int, default=30000)
    ap.add_argument("--clean-seeds", type=int, default=3,
                    dest="clean_seeds",
                    help="independent clean-deploy loads (the false-"
                    "positive pin)")
    ap.add_argument("--canary-frac", type=float, default=0.25,
                    dest="canary_frac")
    ap.add_argument("--min-samples", type=int, default=12,
                    dest="min_samples")
    ap.add_argument("--alpha", type=float, default=1e-3)
    ap.add_argument("--min-events", type=int, default=4,
                    dest="min_events")
    ap.add_argument("--min-event-total", type=int, default=8,
                    dest="min_event_total")
    ap.add_argument("--soak-ticks", type=int, default=250,
                    dest="soak_ticks")
    ap.add_argument("--max-window-ticks", type=int, default=900,
                    dest="max_window_ticks")
    ap.add_argument("--slow-factor", type=int, default=3,
                    dest="slow_factor",
                    help="regressed replica runs 1 of N fleet ticks")
    ap.add_argument("--n-probes", type=int, default=3,
                    dest="n_probes")
    ap.add_argument("--probe-prompt-len", type=int, default=8,
                    dest="probe_prompt_len")
    ap.add_argument("--probe-new-tokens", type=int, default=6,
                    dest="probe_new_tokens")
    ap.add_argument("--probe-seed", type=int, default=0xCA9A,
                    dest="probe_seed")
    ap.add_argument("--json", default=None, metavar="OUT")
    ap.add_argument("--spans", default=None, metavar="OUT")
    ap.add_argument("--span-capacity", type=int, default=131072)
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

    fp = art["fingerprints"]
    print(
        "canary drill: fingerprint %s rebuild_exact=%s "
        "single_bit_flips=%s restore=%s"
        % (fp["digest"][:12], fp["rebuild_bit_exact"],
           fp["single_bit_flips_digest"], fp["restore_matches"])
    )
    for run in art["clean_runs"]:
        d = run["deploys"][-1] if run["deploys"] else {}
        c = d.get("canary", {})
        print(
            "  %s: %d/%d completed, verdict=%s exposure=%.3f "
            "lost=%s"
            % (run["label"], run["completed"], run["offered"],
               c.get("verdict"), c.get("exposure_frac", float("nan")),
               d.get("lost_requests"))
        )
    reg = art["regression"]
    d = reg["deploys"][-1] if reg["deploys"] else {}
    c = d.get("canary", {})
    print(
        "  regression: %d/%d completed (%s), verdict=%s "
        "detect_ticks=%s rolled_back=%d"
        % (reg["completed"], reg["offered"],
           ", ".join(f"{k}={v}" for k, v in
                     sorted(reg["shed_reasons"].items())) or "no shed",
           c.get("verdict"), art["detect_ticks"],
           int(reg["rolled_back"]))
    )
    print(
        "  exposure: routed %s/%s (frac %.3f <= %.2f), tokens %s/%s"
        % (c.get("canary_routed"), c.get("routed"),
           c.get("exposure_frac", float("nan")), args.canary_frac,
           c.get("tokens_canary"), c.get("tokens_total"))
    )

    failures = check(args, art)
    for msg in failures:
        print(f"CANARY DRILL FAIL: {msg}", file=sys.stderr)
    if not failures:
        print("canary drill: PASS")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
