"""One in-process serving replica — engine + scheduler + namespace.

Counterpart of ``apex_tpu/fleetctl/replica.py``, host code copied over;
:meth:`EngineReplica.redeploy` swaps weights through the port engine's
:meth:`~apex_tpu_torch.serve.InferenceEngine.swap_weights`.

An :class:`EngineReplica` is the fleet control plane's unit of
scheduling: a full engine/scheduler pair with its OWN
:class:`~apex_tpu_torch.serve.cache.PagePool`,
:class:`~apex_tpu_torch.observability.metrics.MetricRegistry`, and (optional)
:class:`~apex_tpu_torch.observability.ometrics.OpsServer` — sharing only the
fleet's clock and :class:`~apex_tpu_torch.observability.spans.SpanRecorder`
(request ids are globally unique, so every replica's request chains
merge onto one timeline).  Pages are replica-local by construction:
a request that leaves a replica (drain handoff, crash evacuation,
preemption) drops its pages and generated prefix and re-prefills on
its destination — what it KEEPS is its prompt, its original
``submitted_at`` (end-to-end TTFT honesty), and its shared retry
budget (``Request.retries`` travels with the object, so a request
that faults on replica A and again on replica B burns ONE
``max_retries`` budget, not one per replica).

Lifecycle::

    live ──(begin_drain)──▶ draining ──(finish_drain)──▶ dead
      │                                   └─(redeploy)──▶ live
      ├──(crash/evacuate)──▶ dead
      └──(eject/evacuate)──▶ ejected ──(rejoin)──▶ live

See docs/serving.md ("Fleet operations").
"""

from __future__ import annotations

from typing import Dict, List, Optional

from apex_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)

__all__ = [
    "LIVE",
    "DRAINING",
    "EJECTED",
    "DEAD",
    "EngineReplica",
]

LIVE = "live"
DRAINING = "draining"
#: evacuated for a health page (burn rate, hung iteration) — the
#: engine survives and the replica can :meth:`~EngineReplica.rejoin`
EJECTED = "ejected"
#: crashed, preempted away, scaled in, or retired — terminal
DEAD = "dead"


class EngineReplica:
    """A named scheduler/engine pair under fleet control.

    ``sched_kwargs`` pass through to the scheduler (queue bounds,
    retry budget, clamp knobs) — the fleet's retry semantics REQUIRE a
    uniform ``max_retries`` across replicas (a re-routed request's
    consumed budget must mean the same thing wherever it lands).
    """

    def __init__(self, name: str, engine, *, clock, spans=None,
                 registry=None, **sched_kwargs):
        self.name = str(name)
        self.engine = engine
        self.registry = registry if registry is not None else engine.registry
        self.sched = ContinuousBatchingScheduler(
            engine, registry=self.registry, clock=clock, spans=spans,
            **sched_kwargs,
        )
        self.state = LIVE
        #: why the current/last drain ran: "preempt" | "scale_in" |
        #: "deploy" (the fleet dispatches on it at finish_drain)
        self.drain_reason: Optional[str] = None
        #: why the replica ended (crash cause, eject cause, ...)
        self.end_cause: Optional[str] = None
        self.drain_reports: List[Dict[str, object]] = []
        #: golden-probe fingerprints taken on this replica, in order
        #: (:meth:`probe` appends) — the canary gate's identity ledger
        self.fingerprints: List[Dict[str, object]] = []
        self.ops = None

    def __repr__(self) -> str:
        return (
            f"EngineReplica({self.name!r}, state={self.state!r}, "
            f"depth={self.depth})"
        )

    # -- serving -----------------------------------------------------------
    @property
    def pending(self) -> bool:
        return self.sched.pending

    @property
    def depth(self) -> int:
        """Routing load signal: queued + running requests."""
        return len(self.sched.queue) + len(self.sched.running)

    @property
    def progress(self) -> int:
        """A counter that moves iff the replica is doing work — the
        fleet's hung-iteration detector watches it."""
        s = self.sched
        return s._tokens_out + len(s.completed) + len(s.shed)

    def step(self) -> None:
        self.sched.step()

    # -- ops export --------------------------------------------------------
    def start_ops(self, **kwargs):
        """An ephemeral-port :class:`~apex_tpu_torch.observability.ometrics.
        OpsServer` namespaced by replica name: N replicas in one
        process each get their own ``/metrics`` on an OS-assigned port
        (``server.port`` after start) with no board-key collisions."""
        from apex_tpu_torch.observability.ometrics import OpsServer

        registries = [self.registry] if self.registry is not None else []
        collect = self.registry.fetch if self.registry is not None else None
        kwargs.setdefault("collect", collect)
        self.ops = OpsServer(
            registries=registries, histograms=[self.sched.ttft_hist],
            name=self.name, port=0, **kwargs,
        ).start()
        return self.ops

    def stop_ops(self) -> None:
        if self.ops is not None:
            self.ops.stop()
            self.ops = None

    # -- drain (preempt / scale-in / rolling deploy) -----------------------
    def begin_drain(self, handoff, *, reason: str) -> int:
        """Enter the draining state: never-admitted work re-routes
        through ``handoff``, running + retrying work finishes HERE
        over the following fleet ticks (the preemption grace period).
        The fleet keeps stepping this replica until ``pending``
        clears, then calls :meth:`finish_drain`."""
        if self.state != LIVE:
            raise RuntimeError(
                f"replica {self.name} cannot drain from {self.state!r}"
            )
        self.state = DRAINING
        self.drain_reason = reason
        return self.sched.start_drain(handoff=handoff)

    def finish_drain(self) -> Dict[str, object]:
        """Seal the drain (pool re-proven empty) and report.  The
        caller decides what the replica becomes next (dead for a
        preemption/scale-in, :meth:`redeploy` for a rolling update)."""
        report = self.sched.finish_drain()
        report["replica"] = self.name
        report["reason"] = self.drain_reason
        self.drain_reports.append(report)
        return report

    def redeploy(self, params, draft_params=None) -> None:
        """Swap in new weights and return to service (the rolling
        update's per-replica step).  ``params`` is a
        :class:`~apex_tpu_torch.models.GptModel` (the new weights,
        prepared into tensors of this replica's own) or an engine's
        prepared weights (the incumbent a rollback restores, adopted as
        they are, so the rollback is bit for bit); ``draft_params`` ships
        a refreshed draft the same way, and a self-draft follows the new
        target.  :meth:`~apex_tpu_torch.serve.InferenceEngine.swap_weights`
        re-captures every graph (the old graphs read the old tensors'
        addresses), then admissions resume.  The new weights never go
        into the old tensors: replicas built from one model share them,
        and an in-place copy would deploy to every replica at once."""
        if self.sched.pending:
            raise RuntimeError(
                f"replica {self.name} redeployed with work in flight"
            )
        if self.sched.prefix is not None:
            # cached prefix runs hold old-weight K/V — garbage under
            # the new weights, and they pin pages the cache reset
            # below requires free
            self.sched.prefix.flush()
        # the drained pool is empty, so re-zero the KV pages: stale K/V
        # written by the OUTGOING weights must not leak into the new
        # tenancy through recycled pages (a NaN-poisoned row survives
        # the attention mask — 0 * NaN — and would break the canary
        # rollback's bit-exact fingerprint)
        self.engine.reset_cache()
        self.engine.swap_weights(params, draft_params)
        self.sched.resume()
        self.state = LIVE
        self.drain_reason = None

    def probe(self, probes) -> Dict[str, object]:
        """Golden-probe fingerprint of the CURRENT weights
        (:func:`apex_tpu_torch.observability.canary.model_fingerprint`),
        appended to :attr:`fingerprints`.  Callers probe quiet
        replicas — freshly built, drained, or just-redeployed — where
        the pool has room for the probe's transient pages; the
        canary-gated deploy probes at exactly those moments."""
        from apex_tpu_torch.observability.canary import model_fingerprint

        fp = model_fingerprint(self.engine, probes)
        self.fingerprints.append(fp)
        return fp

    # -- evacuation (crash / ejection) -------------------------------------
    def evacuate(self, cause: str) -> List[Request]:
        """Empty the replica NOW (a crash or health ejection — no
        grace period): every running request moves through the
        ``retrying`` phase (charging the SHARED retry budget — one
        that already burned it sheds ``retries_exhausted`` here,
        terminally), then the whole queue is offered out with pages
        dropped and prompts retained.  Returns the survivors for the
        router to re-route; the pool is left provably empty."""
        sched = self.sched
        out: List[Request] = []

        def accept(req: Request) -> bool:
            out.append(req)
            return True

        for i, req in enumerate(sched.slots):
            if req is None:
                continue
            sched.slots[i] = None
            sched._send_to_retry(req, cause)
        while sched.queue:
            req = sched.queue.popleft()
            sched._reroute_request(req, accept)
        if sched.prefix is not None:
            # cached runs are replica-local history: release the
            # cache's own references so the pool-empty proof below
            # covers the cache too (borrowed copies were already
            # dropped by the retry/re-route frees above)
            sched.prefix.flush()
        sched.leak_check()
        assert sched.pool.in_use == 0, (
            f"replica {self.name} evacuated with pages in use"
        )
        # the replica will never step again — publish NOW or the
        # retry/reroute counters this evacuation just wrote stay
        # unmaterialized on device state and vanish from every
        # fleet-level aggregation (the dead replica's ledger is part
        # of the fleet's goodput truth)
        sched._publish()
        self.end_cause = cause
        return out

    # -- health ------------------------------------------------------------
    def goodput_counts(self):
        """Cumulative ``(good, total)`` for the per-replica burn-rate
        tracker: completed vs terminally-resolved (``sched.shed`` holds
        only TERMINAL sheds — re-routed requests are not failures, they
        are still in flight elsewhere)."""
        done = len(self.sched.completed)
        return float(done), float(done + len(self.sched.shed))
