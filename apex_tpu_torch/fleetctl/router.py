"""Fleet router — the one front door over N replicas.

Counterpart of ``apex_tpu/fleetctl/router.py``, host code copied over.

Requests enter the fleet at the router's **door** (an unbounded fleet
queue — per-replica backpressure still applies at each replica's own
bounded admission queue) and are dispatched once per fleet tick to the
least-loaded LIVE replica (deterministic: load = queued + running,
ties break on replica name).  Every dispatch records the validated
``routed`` span phase (:data:`~apex_tpu_torch.observability.spans.
REQ_ROUTED`) carrying the destination replica — the timeline shows
exactly which replica each request (and each re-route) landed on.

The router is also the fleet's re-admission path: a replica draining
for a preemption or rolling deploy hands its never-admitted queue to
:meth:`Router.reroute` (the ``scheduler.drain(handoff=)`` hook), and a
crashed replica's evacuated requests arrive the same way.  A re-routed
request is reset to prompt-only — pages are replica-local, the
destination re-prefills — while its original ``submitted_at``,
accumulated queue-wait, and SHARED retry budget ride along unchanged.

Chaos: the ``fleet.router`` site faults a whole dispatch tick (the
transient routing error) — requests stay at the door and go out on the
next tick; nothing is lost, the ``fleet/router_faults`` counter says
it happened.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, Iterable, List, Optional

from apex_tpu_torch.observability.spans import REQ_ROUTED
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.serve.scheduler import QUEUED, Request

from apex_tpu_torch.fleetctl.replica import LIVE, EngineReplica

__all__ = ["Router", "aggregate_expositions"]


class Router:
    """Least-loaded dispatch + re-routing over a replica set.

    ``count`` is the fleet's counter hook (``callable(name, n=1)``) so
    router traffic lands on the fleet ledger without the router owning
    a registry.
    """

    def __init__(self, *, clock, spans=None, count=None):
        self.clock = clock
        self.spans = spans
        self._count = count if count is not None else (lambda name, n=1: None)
        self.door: Deque[Request] = collections.deque()
        #: dispatch ticks lost to an injected ``fleet.router`` fault
        self.faulted_ticks = 0
        # canary hold: while set, the named replica's share of routed
        # requests is capped at `frac` (the deploy exposure bound)
        self._canary_name: Optional[str] = None
        self._canary_frac = 0.0
        self.window_routed = 0
        self.window_canary = 0

    # -- canary hold -------------------------------------------------------
    def set_canary(self, name: str, frac: float) -> None:
        """Open a canary hold: until :meth:`clear_canary`, replica
        ``name`` receives at most ``frac`` of the window's dispatches
        (enforced per-request, counted from zero at the hold's open) —
        THE mechanism behind the deploy's provable bad-weight exposure
        bound.  Every canary dispatch is additionally annotated
        ``canary=True`` on its validated ``routed`` span, so the bound
        is re-provable from the span dump alone."""
        self._canary_name = str(name)
        self._canary_frac = float(frac)
        self.window_routed = 0
        self.window_canary = 0

    def clear_canary(self) -> Dict[str, Any]:
        """Close the hold; returns the window's routing tallies."""
        stats = {
            "canary": self._canary_name,
            "frac": self._canary_frac,
            "routed": self.window_routed,
            "canary_routed": self.window_canary,
        }
        self._canary_name = None
        self._canary_frac = 0.0
        return stats

    def _canary_admissible(self) -> bool:
        """Would one more canary dispatch keep the window share within
        the hold?  ``(canary + 1) <= frac * (routed + 1)`` — the +1s
        make the very first dispatches honest (0/0 is not "under")."""
        return (self.window_canary + 1) <= \
            self._canary_frac * (self.window_routed + 1)

    # -- intake ------------------------------------------------------------
    def submit(self, req: Request) -> Request:
        """A NEW request enters the fleet (dispatched next tick)."""
        self._count("fleet/submitted")
        self.door.append(req)
        return req

    def reroute(self, req: Request) -> bool:
        """Re-admit a request another replica gave up (drain handoff /
        crash evacuation): reset it to prompt-only — the pages were
        already freed to their OWN pool by the shedding scheduler, the
        generated prefix is untrusted without them — and queue it at
        the door.  ``submitted_at`` (end-to-end TTFT), accumulated
        ``queue_blocked_s``, any clamp, and the consumed ``retries``
        budget are deliberately PRESERVED.  Always accepts (the door
        is the fleet's unbounded holding area); the bool return is the
        ``drain(handoff=)`` contract."""
        assert not req.pages, (
            f"re-routed request {req.rid} still holds pages — they are "
            f"replica-local and must be freed by the source scheduler"
        )
        req.tokens = []
        req.ctx_len = 0
        req.status = QUEUED
        req.admitted_at = None
        req.first_token_at = None
        req.blocked_since = None
        req.first_decode_iter = None
        req.last_decode_iter = None
        # prefix-cache state is replica-local too: the source's hit
        # (borrowed pages, skipped positions) means nothing on the
        # destination — it probes its OWN cache afresh
        req.prefill_pos = 0
        req.cache_hit_tokens = 0
        req.cache_hit_pages = 0
        req.cache_probed = False
        req.prefill_started_at = None
        self._count("fleet/rerouted")
        self.door.append(req)
        return True

    # -- dispatch ----------------------------------------------------------
    @staticmethod
    def pick(replicas: Iterable[EngineReplica],
             prompt=None) -> Optional[EngineReplica]:
        """The routing policy: least-loaded LIVE replica WITH queue
        headroom, name as the deterministic tie-break.  A replica
        whose bounded admission queue is already full is not a routing
        candidate — force-feeding it would convert fleet-survivable
        backpressure into terminal ``shed(queue_full)``; when every
        replica is saturated the door holds the traffic (that is the
        queue-depth pressure the autoscaler scales out on).

        **Prefix affinity**: with a ``prompt``, candidates whose
        prefix cache already holds part of it are preferred — deepest
        hit first (the probe is a non-touching
        :meth:`~apex_tpu_torch.serve.cache.PrefixCache.peek_tokens`, so
        routing does not mutate any replica's LRU order), then the
        same (depth, name) deterministic tie-break.  Replicas without
        a cache probe as 0, so a cacheless fleet routes exactly as
        before."""
        live = [
            r for r in replicas
            if r.state == LIVE and (
                r.sched.max_queue_depth is None
                or len(r.sched.queue) < r.sched.max_queue_depth
            )
        ]
        if not live:
            return None
        if prompt:
            best = min(
                live,
                key=lambda r: (-Router.peek_cached(r, prompt),
                               r.depth, r.name),
            )
            if Router.peek_cached(best, prompt) > 0:
                return best
        return min(live, key=lambda r: (r.depth, r.name))

    @staticmethod
    def peek_cached(rep: EngineReplica, prompt) -> int:
        """Prompt tokens ``rep``'s prefix cache would cover (0 when the
        replica runs without a cache)."""
        prefix = rep.sched.prefix
        return prefix.peek_tokens(prompt) if prefix is not None else 0

    def dispatch(self, replicas: List[EngineReplica], tick: int) -> int:
        """Route everything at the door to live replicas (one fleet
        tick).  Returns the number dispatched; 0 when the ``fleet.
        router`` chaos site faults this tick or no replica is live —
        either way the door RETAINS its requests for the next tick."""
        # chaos BEFORE the empty-door fast path: a fault scheduled at
        # this tick must fire (and be ledgered) even when there is
        # nothing to route — a drill asserting "every spec'd site
        # fired" must not depend on door occupancy at the fault tick
        if chaos.active(chaos.FLEET_ROUTER, tick) is not None:
            self._count("fleet/router_faults")
            self.faulted_ticks += 1
            return 0
        if not self.door:
            return 0
        dispatched = 0
        for _ in range(len(self.door)):
            req = self.door[0]
            target = self.pick(replicas, prompt=req.prompt)
            is_canary = (
                self._canary_name is not None
                and target is not None
                and target.name == self._canary_name
            )
            if is_canary and not self._canary_admissible():
                # the hold: re-pick from the non-canary pool; if no
                # incumbent can take it, the request WAITS at the door
                # — holding is what makes the exposure bound provable
                # (the door's depth is the autoscaler's scale-out
                # signal, and an inconclusive window expires, so a
                # canary-only fleet cannot deadlock here)
                target = self.pick(
                    [r for r in replicas
                     if r.name != self._canary_name],
                    prompt=req.prompt,
                )
                is_canary = False
            if target is None:
                break
            self.door.popleft()
            if self.peek_cached(target, req.prompt) > 0:
                self._count("fleet/prefix_affinity_hits")
            now = self.clock()
            span_args: Dict[str, Any] = {"replica": target.name}
            if self._canary_name is not None:
                self.window_routed += 1
                if is_canary:
                    self.window_canary += 1
                    self._count("fleet/canary/routed")
                    # validated annotation: legal only on a routed hop
                    # inside an open deploy window (spans.py enforces)
                    span_args["canary"] = True
            if self.spans is not None:
                # the validated `routed` phase: opened here with the
                # destination, closed by the target's own `queued`
                # event — the hop is on the timeline, replica named
                self.spans.request_event(
                    req.rid, REQ_ROUTED, now, **span_args,
                )
            self._count("fleet/routed")
            target.sched.submit(req)
            dispatched += 1
        return dispatched


def aggregate_expositions(texts: Iterable[str]) -> Dict[str, Any]:
    """Fold N per-replica OpenMetrics expositions (each replica's
    :meth:`~apex_tpu_torch.observability.ometrics.OpsServer.scrape`) into a
    fleet view: counters SUM across replicas, gauges are kept
    per-source (summing a queue-depth gauge is meaningful, summing a
    page-size gauge is not — the caller picks its aggregation).
    Every input is parsed through the validating
    :func:`~apex_tpu_torch.observability.ometrics.parse_exposition`, so a
    malformed replica exposition fails the aggregation loudly."""
    from apex_tpu_torch.observability.ometrics import parse_exposition

    counters: Dict[str, float] = {}
    gauges: Dict[str, List[float]] = {}
    sources = 0
    for text in texts:
        sources += 1
        for family, fam in parse_exposition(text).items():
            value = fam.get("value")
            if value is None:
                continue
            if fam.get("type") == "counter":
                counters[family] = counters.get(family, 0.0) + float(value)
            elif fam.get("type") == "gauge":
                gauges.setdefault(family, []).append(float(value))
    return {"sources": sources, "counters": counters, "gauges": gauges}
