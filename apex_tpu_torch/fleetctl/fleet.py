"""The fleet control plane: N replicas, one door, failure as input.

Counterpart of ``apex_tpu/fleetctl/fleet.py``, host code copied over.

:class:`Fleet` composes the pieces — :class:`~apex_tpu_torch.fleetctl.
replica.EngineReplica` (engine + scheduler + own pool/registry),
:class:`~apex_tpu_torch.fleetctl.router.Router` (least-loaded dispatch +
re-routing), :class:`~apex_tpu_torch.fleetctl.autoscale.Autoscaler`
(burn-rate capacity control) — into one deterministic tick loop
(:meth:`Fleet.step`), drillable on a virtual clock:

1. chaos: the ``fleet.replica_crash`` / ``fleet.preempt`` sites fire
   against the tick index — a crash evacuates the victim NOW (running
   work through the shared retry budget, queue re-routed with pages
   dropped and prompts kept), a preempt notice starts a graceful
   drain (running work finishes over the grace ticks, never-admitted
   work re-routes immediately);
2. the rolling-update state machine advances (drain one replica at a
   time — never the last live one — rebuild with the new weights
   through the supervised path, re-admit);
3. the router dispatches the door (``fleet.router`` chaos can fault a
   whole tick — requests wait);
4. every live/draining replica takes one scheduler iteration; drains
   that emptied are sealed (pool re-proven empty) and dispatched on
   their reason (preempt/scale-in → dead, deploy → redeploy);
5. health: a replica whose progress counter froze for ``hung_ticks``
   with work pending is EJECTED (evacuated, re-routable later via
   :meth:`rejoin`); an optional per-replica goodput burn page ejects
   the same way;
6. the autoscaler evaluates; executed decisions spawn or drain-retire
   a replica and land as ``fleet_scale_out``/``fleet_scale_in``
   health instants on the shared span timeline.

Fleet **goodput** is accounted across churn: a request counts exactly
once fleet-wide (``completed`` on whichever replica finished it, a
terminal ``shed`` wherever it truly ended) — re-routes are ledgered
per-replica as ``shed(rerouted)`` but are NOT terminals.  See
docs/serving.md ("Fleet operations").
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from apex_tpu_torch.observability.health import HealthEvent
from apex_tpu_torch.observability.metrics import MetricRegistry
from apex_tpu_torch.observability.slo import BurnRateTracker
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.serve.scheduler import Request

from apex_tpu_torch.fleetctl.replica import (
    DEAD,
    DRAINING,
    EJECTED,
    LIVE,
    EngineReplica,
)
from apex_tpu_torch.fleetctl.router import Router, aggregate_expositions

__all__ = ["declare_fleet_metrics", "Fleet"]


def declare_fleet_metrics(registry) -> None:
    """Declare the fleet ledger on a registry (idempotent)."""
    for c in ("fleet/submitted", "fleet/routed", "fleet/rerouted",
              "fleet/prefix_affinity_hits",
              "fleet/router_faults", "fleet/replica_crashes",
              "fleet/preempts", "fleet/ejections", "fleet/rejoins",
              "fleet/scale_out", "fleet/scale_in", "fleet/deploys",
              "fleet/deploys_rolled_back", "fleet/spawned",
              "fleet/canary/probes", "fleet/canary/routed",
              "fleet/canary/verdict_pass", "fleet/canary/verdict_fail"):
        registry.counter(c)
    for g in ("fleet/replicas_live", "fleet/door_depth",
              "fleet/canary/fingerprint_distance",
              "fleet/canary/detect_ticks", "fleet/canary/exposure_frac"):
        registry.gauge(g)


class Fleet:
    """N in-process replicas behind one router, one tick at a time.

    ``replica_factory(name)`` builds a fresh :class:`EngineReplica`
    (its own engine, pool, registry) wired to the SHARED fleet clock
    and span recorder — that wiring is the factory's contract; the
    fleet only names and owns the result.
    """

    def __init__(self, replica_factory: Callable[[str], EngineReplica],
                 *, replicas: int = 2, clock=time.monotonic, spans=None,
                 autoscaler=None, registry: Optional[MetricRegistry] = None,
                 hung_ticks: int = 200,
                 eject_burn_factor: Optional[float] = None,
                 eject_burn_window_s: float = 2.0,
                 eject_objective: float = 0.8):
        self.clock = clock
        self.spans = spans
        self.registry = (
            registry if registry is not None
            else MetricRegistry(fetch_every=1)
        )
        declare_fleet_metrics(self.registry)
        self._mstate = self.registry.init()
        self.router = Router(clock=clock, spans=spans, count=self._count)
        self.replica_factory = replica_factory
        self.replicas: List[EngineReplica] = []
        self._next_id = 0
        self.tick = 0
        self.autoscaler = autoscaler
        self.hung_ticks = int(hung_ticks)
        self._progress: Dict[str, tuple] = {}  # name -> (tick, counter)
        self.eject_burn_factor = eject_burn_factor
        self._eject_trackers: Dict[str, BurnRateTracker] = {}
        self._eject_burn_window_s = float(eject_burn_window_s)
        self._eject_objective = float(eject_objective)
        #: the in-progress rolling update, or None
        self.deploy: Optional[Dict[str, object]] = None
        #: canary window observer for the in-progress deploy, or None
        self._canary_ctl = None
        #: completed rolling updates, newest last
        self.deploy_history: List[Dict[str, object]] = []
        self.health_events: List[HealthEvent] = []
        for _ in range(int(replicas)):
            self._spawn()

    # -- plumbing ----------------------------------------------------------
    def _count(self, name: str, n: float = 1.0) -> None:
        self._mstate = self.registry.update(self._mstate, {name: n})

    def _gauge(self, name: str, value: float) -> None:
        self._mstate = self.registry.update(
            self._mstate, {name: float(value)}
        )

    def _note(self, event: HealthEvent) -> None:
        self.health_events.append(event)
        if self.spans is not None:
            self.spans.note_health(event)

    def _spawn(self) -> EngineReplica:
        name = f"r{self._next_id}"
        self._next_id += 1
        rep = self.replica_factory(name)
        rep.name = name
        self.replicas.append(rep)
        self._count("fleet/spawned")
        if self.deploy is not None:
            phase = self.deploy.get("phase", "rolling")
            if phase == "rolling":
                # born mid-deploy: the factory built it with the OLD
                # weights — swap in the deploy's params before it takes
                # any traffic, or the "rolling update complete" claim
                # would be false for the newest replica
                rep.redeploy(
                    self.deploy["params"],
                    self.deploy.get("draft_params"),
                )
                self.deploy["updated"].append(name)
            elif phase in ("canary_pending", "canary"):
                # born before the canary verdict: it KEEPS the
                # incumbent weights the factory built it with (the
                # exposure bound says at most the canary serves the
                # unproven weights) and queues for the rolling phase
                # so a PASS still updates it
                self.deploy["remaining"].append(name)
            # phase == "rollback": incumbent weights, and the deploy
            # is being unwound — nothing to do
        if self.eject_burn_factor is not None:
            self._eject_trackers[name] = BurnRateTracker(
                self._eject_objective, self._eject_burn_window_s,
            )
        return rep

    def replica(self, name: str) -> EngineReplica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}")

    @property
    def live(self) -> List[EngineReplica]:
        return [r for r in self.replicas if r.state == LIVE]

    @property
    def pending(self) -> bool:
        """Work anywhere in the fleet: at the door, on a live or
        draining replica, or a rolling update still in progress."""
        if self.door_depth:
            return True
        if self.deploy is not None:
            return True
        return any(
            r.sched.pending for r in self.replicas
            if r.state in (LIVE, DRAINING)
        )

    @property
    def door_depth(self) -> int:
        return len(self.router.door)

    # -- intake ------------------------------------------------------------
    def submit(self, req: Request) -> Request:
        return self.router.submit(req)

    # -- failure handling --------------------------------------------------
    def _evacuate_to_router(self, rep: EngineReplica, cause: str) -> int:
        moved = 0
        for req in rep.evacuate(cause):
            self.router.reroute(req)
            moved += 1
        return moved

    def crash(self, rep: EngineReplica, cause: str = "replica_crash") -> int:
        """Kill a replica NOW (the ``fleet.replica_crash`` path): its
        work evacuates through the shared retry budget and the replica
        is dead.  Returns how many requests moved to the router."""
        self._count("fleet/replica_crashes")
        moved = self._evacuate_to_router(rep, cause)
        rep.state = DEAD
        self._note(HealthEvent(
            "fleet_replica_crash", "critical", self.tick, float(moved),
            0.0,
            f"replica {rep.name} crashed ({cause}); {moved} requests "
            f"re-routed, {len(self.live)} replicas live",
        ))
        return moved

    def preempt(self, rep: EngineReplica) -> None:
        """Deliver a preempt notice (the ``fleet.preempt`` path): the
        replica drains gracefully — never-admitted work re-routes NOW,
        running work finishes over the following ticks (the grace
        period) — then leaves the fleet."""
        self._count("fleet/preempts")
        rerouted = rep.begin_drain(self.router.reroute, reason="preempt")
        self._note(HealthEvent(
            "fleet_preempt", "warn", self.tick, float(rerouted), 0.0,
            f"replica {rep.name} preempted: draining, {rerouted} "
            f"queued requests re-routed",
        ))

    def eject(self, rep: EngineReplica, cause: str) -> int:
        """Health-based ejection (burn-rate page, hung iteration):
        evacuate like a crash, but keep the replica for a possible
        :meth:`rejoin` once the operator (or a drill) clears it."""
        self._count("fleet/ejections")
        moved = self._evacuate_to_router(rep, cause)
        rep.state = EJECTED
        self._note(HealthEvent(
            "fleet_eject", "critical", self.tick, float(moved), 0.0,
            f"replica {rep.name} ejected ({cause}); {moved} requests "
            f"re-routed",
        ))
        return moved

    def rejoin(self, rep: EngineReplica) -> None:
        """Re-admit an ejected replica to the routing set."""
        if rep.state != EJECTED:
            raise RuntimeError(
                f"replica {rep.name} cannot rejoin from {rep.state!r}"
            )
        self._count("fleet/rejoins")
        rep.state = LIVE
        rep.end_cause = None
        self._progress.pop(rep.name, None)
        self._note(HealthEvent(
            "fleet_rejoin", "info", self.tick, 0.0, 0.0,
            f"replica {rep.name} rejoined the fleet",
        ))

    # -- health detection --------------------------------------------------
    def _check_hung(self, rep: EngineReplica) -> bool:
        """A live replica with pending work whose progress counter has
        not moved for ``hung_ticks`` is wedged — eject it."""
        if not rep.sched.pending:
            self._progress.pop(rep.name, None)
            return False
        seen = self._progress.get(rep.name)
        now = rep.progress
        if seen is None or seen[1] != now:
            self._progress[rep.name] = (self.tick, now)
            return False
        if self.tick - seen[0] >= self.hung_ticks:
            self.eject(rep, "hung")
            return True
        return False

    def _check_burn(self, rep: EngineReplica) -> bool:
        """Optional per-replica goodput burn page → ejection."""
        if self.eject_burn_factor is None:
            return False
        tracker = self._eject_trackers.get(rep.name)
        if tracker is None:
            return False
        good, total = rep.goodput_counts()
        if total <= 0:
            return False
        now = self.clock()
        tracker.observe(good, total, now)
        burn = tracker.burn_rate(self._eject_burn_window_s / 2.0, now)
        if burn is not None and burn >= self.eject_burn_factor:
            self.eject(rep, f"burn_rate:{burn:.1f}x")
            return True
        return False

    # -- rolling update ----------------------------------------------------
    def start_rolling_update(self, params, draft_params=None, *,
                             canary=None) -> None:
        """Begin a zero-downtime deploy of ``params``: replicas drain
        ONE AT A TIME (never the last live one — the fleet keeps
        serving throughout), rebuild through the supervised path, and
        re-admit.  Advanced by :meth:`step`; done when
        :attr:`deploy` is None again.  ``draft_params`` ships a
        refreshed speculative draft on the same deploy — every updated
        replica carries it through its redeploy (self-draft replicas
        re-alias the new target weights automatically).

        ``canary`` (a :class:`~apex_tpu_torch.observability.canary.
        CanaryConfig`) gates the deploy: the FIRST updated replica
        becomes the canary — golden-probe fingerprinted before and
        after the weight swap (old→new distance on the board) — and
        the router holds its load share at ``canary.frac`` while a
        :class:`~apex_tpu_torch.observability.canary.CanaryController`
        compares its windowed metric distributions against the
        incumbent pool.  The deploy proceeds to the remaining replicas
        only on a PASS verdict; a FAIL halts it, drains the canary,
        rebuilds it back to the captured incumbent weights, and bumps
        ``fleet/deploys_rolled_back`` — bad-weight exposure is bounded
        by the canary fraction, re-provable from the span dump."""
        if self.deploy is not None:
            raise RuntimeError("a rolling update is already in progress")
        self.deploy = {
            "params": params,
            "draft_params": draft_params,
            "remaining": [r.name for r in self.live],
            "current": None,
            "updated": [],
            "started_tick": self.tick,
            "draining_shed_before": self.shed_count("draining"),
            "phase": "rolling" if canary is None else "canary_pending",
        }
        if canary is not None:
            from apex_tpu_torch.observability.canary import CanaryConfig

            if not isinstance(canary, CanaryConfig):
                raise TypeError(
                    f"canary must be a CanaryConfig, got {type(canary)}"
                )
            self.deploy["canary_cfg"] = canary
            self.deploy["canary"] = {"frac": canary.frac}
        self._canary_ctl = None

    def _advance_deploy(self) -> None:
        d = self.deploy
        if d is None:
            return
        phase = d.get("phase", "rolling")
        if phase == "canary":
            self._canary_tick()
            return
        if phase == "rollback":
            return  # the canary's rollback drain completes in the loop
        if d["current"] is not None:
            return  # the per-replica drain completes in the step loop
        while d["remaining"]:
            name = d["remaining"][0]
            rep = self.replica(name)
            if rep.state != LIVE:
                # crashed/preempted away mid-deploy: nothing to update
                d["remaining"].pop(0)
                continue
            if len(self.live) <= 1 and (
                rep.sched.pending or self.door_depth
            ):
                # zero-downtime invariant: never drain the LAST live
                # replica out from under traffic — wait for a
                # scale-out (still allowed mid-deploy) or for the
                # traffic to clear.  A lone IDLE replica with an empty
                # door swaps instantly instead: the drain seals and
                # redeploys on this same tick, before any request can
                # be routed at it.
                return
            d["remaining"].pop(0)
            d["current"] = name
            rep.begin_drain(self.router.reroute, reason="deploy")
            return
        # everything updated — seal the deploy
        d["finished_tick"] = self.tick
        d["draining_shed_after"] = self.shed_count("draining")
        d["lost_requests"] = (
            d["draining_shed_after"] - d["draining_shed_before"]
        )
        self._strip_deploy_weights(d)
        self.deploy_history.append(d)
        self.deploy = None
        self._canary_ctl = None
        self._count("fleet/deploys")
        self._note(HealthEvent(
            "fleet_deploy", "info", self.tick, float(d["lost_requests"]),
            0.0,
            f"rolling update complete: {len(d['updated'])} replicas "
            f"over ticks {d['started_tick']}..{d['finished_tick']}, "
            f"{d['lost_requests']} requests lost to draining",
        ))

    @staticmethod
    def _strip_deploy_weights(d: Dict[str, object]) -> None:
        """Drop the weight trees (and the config object) before a
        deploy record enters :attr:`deploy_history` — the history is
        part of the drill artifact and must stay JSON-sized."""
        for key in ("params", "draft_params", "incumbent_params",
                    "incumbent_draft", "canary_cfg"):
            d.pop(key, None)

    def _seal_drain(self, rep: EngineReplica) -> None:
        report = rep.finish_drain()
        reason = rep.drain_reason
        d = self.deploy
        if reason == "deploy" and d is not None and d["current"] == rep.name:
            if d.get("phase") == "canary_pending":
                self._promote_canary(rep)
            else:
                rep.redeploy(d["params"], d.get("draft_params"))
                d["updated"].append(rep.name)
                d["current"] = None
        elif reason == "canary_rollback" and d is not None:
            self._finish_rollback(rep)
        else:
            rep.state = DEAD
            rep.end_cause = reason
        assert report["pool_in_use"] == 0

    # -- canary gating -----------------------------------------------------
    def _promote_canary(self, rep: EngineReplica) -> None:
        """The drained first replica becomes the canary: capture the
        incumbent weights for a possible rollback, fingerprint the old
        and new weights across the swap (the distance is recorded, not
        judged — an intentional update SHOULD move it), open the
        router hold + deploy window, and baseline the controller."""
        from apex_tpu_torch.observability.canary import (
            CanaryController,
            fingerprint_distance,
        )

        d = self.deploy
        cfg = d["canary_cfg"]
        # the incumbent's prepared weights: redeploy() adopts them back
        # as they are (no re-quantization), so a rollback is bit-exact;
        # the deploy record keeps them alive until it closes
        d["incumbent_params"] = rep.engine.weights
        d["incumbent_draft"] = None
        if rep.engine.spec is not None and \
                rep.engine.draft_weights is not rep.engine.weights:
            # a real (non-self-draft) draft must roll back too; a
            # self-draft follows the target on redeploy
            d["incumbent_draft"] = rep.engine.draft_weights
        summary = d["canary"]
        summary["name"] = rep.name
        if cfg.probes is not None:
            fp_old = rep.probe(cfg.probes)
            self._count("fleet/canary/probes")
        rep.redeploy(d["params"], d.get("draft_params"))
        if cfg.probes is not None:
            fp_new = rep.probe(cfg.probes)
            self._count("fleet/canary/probes")
            dist = fingerprint_distance(fp_old, fp_new)
            self._gauge(
                "fleet/canary/fingerprint_distance", dist["distance"]
            )
            summary["fingerprint"] = {
                "old_digest": fp_old["digest"],
                "new_digest": fp_new["digest"],
                "distance": dist["distance"],
                "streams_differing": dist["streams_differing"],
                "new_finite": fp_new["finite"],
            }
            self._note(HealthEvent(
                "fleet_canary_fingerprint", "info", self.tick,
                float(dist["distance"]), 0.0,
                f"canary {rep.name} fingerprint "
                f"{fp_old['digest'][:12]} -> {fp_new['digest'][:12]} "
                f"(distance {dist['distance']:.3f}, "
                f"finite={fp_new['finite']})",
            ))
        d["updated"].append(rep.name)
        d["current"] = None
        d["phase"] = "canary"
        summary["window_open_tick"] = self.tick
        self.router.set_canary(rep.name, cfg.frac)
        if self.spans is not None:
            self.spans.begin_deploy_window(
                self.clock(), canary=rep.name, frac=cfg.frac
            )
        incumbents = [r for r in self.live if r.name != rep.name]
        self._canary_ctl = CanaryController(rep, incumbents, cfg)

    def _close_canary_window(self, verdict: str) -> Dict[str, object]:
        """Tear down the hold + window and fold the routing tallies
        and token exposure into the deploy's canary summary."""
        d = self.deploy
        stats = self.router.clear_canary()
        if self.spans is not None:
            self.spans.end_deploy_window(self.clock(), verdict=verdict)
        summary = d["canary"]
        summary["verdict"] = verdict
        summary["window_close_tick"] = self.tick
        summary["routed"] = stats["routed"]
        summary["canary_routed"] = stats["canary_routed"]
        exposure = (
            stats["canary_routed"] / stats["routed"]
            if stats["routed"] else 0.0
        )
        summary["exposure_frac"] = exposure
        self._gauge("fleet/canary/exposure_frac", exposure)
        if self._canary_ctl is not None:
            tok_c, tok_total = self._canary_ctl.token_exposure()
            summary["tokens_canary"] = tok_c
            summary["tokens_total"] = tok_total
        self._canary_ctl = None
        return summary

    def _canary_tick(self) -> None:
        """One tick of the open canary window: observe, and act on the
        verdict — FAIL halts immediately (the canary drains for
        rollback), PASS is accepted only after ``soak_ticks`` (early
        quiet is not evidence), and a window that reaches
        ``max_window_ticks`` without meeting the honesty floor closes
        INCONCLUSIVE with a warning and lets the deploy proceed (an
        idle fleet must not wedge a deploy forever)."""
        d = self.deploy
        cfg = d["canary_cfg"]
        summary = d["canary"]
        rep = self.replica(summary["name"])
        win_ticks = self.tick - summary["window_open_tick"]
        if rep.state != LIVE:
            # the canary died mid-window (crash/preempt/eject): the
            # unproven weights are gone with it and nothing else has
            # them — seal the deploy as rolled back
            self._close_canary_window("fail")
            summary["canary_died"] = True
            self._count("fleet/canary/verdict_fail")
            self._note(HealthEvent(
                "fleet_canary_verdict", "critical", self.tick, 0.0, 0.0,
                f"canary {rep.name} left the fleet mid-window "
                f"({rep.state}); deploy rolled back",
            ))
            self._seal_rolled_back()
            return
        ctl = self._canary_ctl
        ctl.observe()
        verdict = ctl.verdict()
        if verdict.status == "fail":
            self._gauge("fleet/canary/detect_ticks", win_ticks)
            summary["detect_ticks"] = win_ticks
            summary["failed_checks"] = [
                {k: v for k, v in c.items()}
                for c in verdict.failed
            ]
            self._close_canary_window("fail")
            self._count("fleet/canary/verdict_fail")
            d["phase"] = "rollback"
            rep.begin_drain(self.router.reroute, reason="canary_rollback")
            self._note(HealthEvent(
                "fleet_canary_verdict", "critical", self.tick,
                float(len(verdict.failed)), 0.0,
                f"canary {rep.name} FAILED after {win_ticks} ticks "
                f"({', '.join(c['metric'] for c in verdict.failed)}); "
                f"deploy halted, rolling back",
            ))
            return
        if verdict.status == "pass" and win_ticks >= cfg.soak_ticks:
            self._gauge("fleet/canary/detect_ticks", win_ticks)
            summary["detect_ticks"] = win_ticks
            self._close_canary_window("pass")
            self._count("fleet/canary/verdict_pass")
            d["phase"] = "rolling"
            self._note(HealthEvent(
                "fleet_canary_verdict", "info", self.tick,
                float(win_ticks), 0.0,
                f"canary {rep.name} PASSED after {win_ticks} ticks "
                f"(exposure {summary['exposure_frac']:.3f} <= "
                f"{cfg.frac}); deploy proceeding",
            ))
            return
        if win_ticks >= cfg.max_window_ticks:
            self._close_canary_window("inconclusive")
            d["phase"] = "rolling"
            self._note(HealthEvent(
                "fleet_canary_inconclusive", "warn", self.tick,
                float(win_ticks), float(cfg.max_window_ticks),
                f"canary {rep.name} window expired below the "
                f"min-sample floor after {win_ticks} ticks; deploy "
                f"proceeding UNPROVEN",
            ))

    def _seal_rolled_back(self) -> None:
        d = self.deploy
        d["finished_tick"] = self.tick
        d["draining_shed_after"] = self.shed_count("draining")
        d["lost_requests"] = (
            d["draining_shed_after"] - d["draining_shed_before"]
        )
        d["rolled_back"] = True
        self._strip_deploy_weights(d)
        self.deploy_history.append(d)
        self.deploy = None
        self._canary_ctl = None
        self._count("fleet/deploys_rolled_back")
        self._note(HealthEvent(
            "fleet_deploy_rollback", "critical", self.tick,
            float(d["lost_requests"]), 0.0,
            f"deploy rolled back at tick {self.tick}: canary "
            f"{d['canary'].get('name')} verdict "
            f"{d['canary'].get('verdict')}, "
            f"{d['lost_requests']} requests lost",
        ))

    def _finish_rollback(self, rep: EngineReplica) -> None:
        """The failed canary's drain sealed: rebuild it back onto the
        captured incumbent weights (bit-exact — the raw params object
        is reassigned, never re-derived) and seal the deploy as rolled
        back."""
        d = self.deploy
        rep.redeploy(d["incumbent_params"], d.get("incumbent_draft"))
        cfg = d.get("canary_cfg")
        if cfg is not None and cfg.probes is not None:
            fp = rep.probe(cfg.probes)
            self._count("fleet/canary/probes")
            d["canary"]["rollback_digest"] = fp["digest"]
        self._seal_rolled_back()

    # -- scaling -----------------------------------------------------------
    def _scale_out(self, event: HealthEvent) -> EngineReplica:
        self._count("fleet/scale_out")
        rep = self._spawn()
        self._note(event)
        return rep

    def _scale_in(self, event: HealthEvent) -> Optional[EngineReplica]:
        candidates = self.live
        if len(candidates) <= 1:
            return None
        # retire the least-loaded live replica (fewest requests to
        # migrate), name as the deterministic tie-break
        victim = min(candidates, key=lambda r: (r.depth, r.name))
        self._count("fleet/scale_in")
        victim.begin_drain(self.router.reroute, reason="scale_in")
        self._note(event)
        return victim

    # -- the tick ----------------------------------------------------------
    def step(self) -> None:
        """One fleet tick (see the module docstring for the order)."""
        tick = self.tick
        # 1. chaos: crash / preempt against the tick index.  Victims
        # are deterministic: the first live replica (crash) and the
        # last (preempt) — distinct under storm specs that fire both.
        live = self.live
        if live and chaos.active(chaos.FLEET_REPLICA_CRASH, tick):
            self.crash(live[0])
        live = self.live
        if live and chaos.active(chaos.FLEET_PREEMPT, tick):
            self.preempt(live[-1])
        # 2. rolling update state machine
        self._advance_deploy()
        # 3. route the door
        self.router.dispatch(self.replicas, tick)
        # 4. one scheduler iteration per active replica; seal finished
        # drains
        for rep in list(self.replicas):
            if rep.state not in (LIVE, DRAINING):
                continue
            if rep.sched.pending:
                rep.step()
            if rep.state == DRAINING and not rep.sched.pending:
                self._seal_drain(rep)
        # 5. health: hung / burning replicas are ejected
        for rep in self.live:
            if not self._check_hung(rep):
                self._check_burn(rep)
        # 6. autoscale.  Scale-OUT stays armed during a rolling update
        # (a deploy under pressure needs MORE capacity — and the
        # zero-downtime guard in _advance_deploy may be waiting on
        # exactly that); scale-in is suppressed until the deploy
        # seals, so capacity only ratchets up mid-deploy.
        if self.autoscaler is not None:
            if not self.live and self.door_depth:
                # total outage with traffic at the door: the burn-rate
                # SLI has no live replica to sample, so the normal
                # evaluation path can never fire — bootstrap capacity
                # directly (one replica per tick until one is live)
                self._scale_out(HealthEvent(
                    "fleet_scale_out", "critical", tick,
                    float(self.door_depth), 0.0,
                    f"no live replicas with {self.door_depth} requests "
                    f"at the door — emergency scale-out",
                ))
            else:
                event = self.autoscaler.evaluate(self.live, tick)
                if event is not None:
                    if event.rule == "fleet_scale_out":
                        self._scale_out(event)
                    elif self.deploy is None:
                        self._scale_in(event)
        self._gauge("fleet/replicas_live", len(self.live))
        self._gauge("fleet/door_depth", self.door_depth)
        self.registry.observe(tick, self._mstate)
        self.tick += 1

    # -- accounting --------------------------------------------------------
    def shed_count(self, reason: Optional[str] = None) -> int:
        """Terminal sheds across EVERY replica ever in the fleet
        (dead ones keep their ledger), optionally for one reason."""
        n = 0
        for rep in self.replicas:
            for req in rep.sched.shed:
                if reason is None or req.shed_reason == reason:
                    n += 1
        return n

    def completed_count(self) -> int:
        return sum(len(rep.sched.completed) for rep in self.replicas)

    def goodput(self) -> Dict[str, object]:
        """Fleet goodput across churn: every request exactly one
        fleet-wide terminal, re-routes excluded (they are hops, not
        outcomes)."""
        completed = self.completed_count()
        shed = self.shed_count()
        in_flight = self.door_depth + sum(
            r.depth for r in self.replicas if r.state in (LIVE, DRAINING)
        )
        submitted = completed + shed + in_flight
        return {
            "completed": completed,
            "shed_terminal": shed,
            "in_flight": in_flight,
            "accounted": submitted,
            "goodput": completed / submitted if submitted else None,
        }

    def leak_check(self) -> Dict[str, int]:
        """Re-prove every replica's page accounting (live, draining,
        ejected AND dead — an evacuated pool must be exactly empty)."""
        in_use = {}
        for rep in self.replicas:
            rep.sched.leak_check()
            in_use[rep.name] = rep.sched.pool.in_use
        return in_use

    def aggregate_values(self) -> Dict[str, float]:
        """Fleet-wide counter view: every replica registry fetched and
        its ``serve/*`` counters summed — the value source for
        :func:`~apex_tpu_torch.observability.slo.fleet_slo_rules`."""
        out: Dict[str, float] = {}
        for rep in self.replicas:
            reg = rep.registry
            if reg is None:
                continue
            reg.fetch()
            for key, value in reg.values().items():
                if key.startswith("serve/") and reg.kind(key) == "counter":
                    out[key] = out.get(key, 0.0) + float(value)
        return out

    def spec_acceptance(self) -> Dict[str, float]:
        """Fleet-wide speculative-decoding acceptance: the router-side
        fold over every replica's draft/accept counters.  A per-replica
        rate can look fine while one stale-draft replica drags the
        fleet — this is the number a deploy decision should read."""
        vals = self.aggregate_values()
        drafted = vals.get("serve/spec_drafted", 0.0)
        accepted = vals.get("serve/spec_accepted", 0.0)
        return {
            "drafted": drafted,
            "accepted": accepted,
            "rate": accepted / drafted if drafted else 0.0,
        }

    def aggregate_scrapes(self) -> Dict[str, object]:
        """The router-side scrape fold: every replica with a running
        :class:`~apex_tpu_torch.observability.ometrics.OpsServer` is scraped
        in-process and the expositions aggregate (counters sum)."""
        texts = [
            rep.ops.scrape() for rep in self.replicas
            if rep.ops is not None
        ]
        return aggregate_expositions(texts)

    def summary(self) -> Dict[str, object]:
        """The drill/ops snapshot."""
        return {
            "tick": self.tick,
            "replicas": [
                {
                    "name": r.name,
                    "state": r.state,
                    "end_cause": r.end_cause,
                    "completed": len(r.sched.completed),
                    "shed": len(r.sched.shed),
                    "pool_in_use": r.sched.pool.in_use,
                    "rebuilds": r.engine.rebuilds,
                }
                for r in self.replicas
            ],
            "door_depth": self.door_depth,
            "goodput": self.goodput(),
            "deploys": list(self.deploy_history),
            "autoscaler_decisions": (
                [e.rule for e in self.autoscaler.decisions]
                if self.autoscaler is not None else []
            ),
            "health_events": [e.rule for e in self.health_events],
        }
