"""Health watchdog — declarative rules over live telemetry.

Counterpart of ``apex_tpu/observability/health.py``: the event type,
the rule base, :class:`Watchdog` and the serving rules, host code copied
over.  :class:`Watchdog` rides the ``run_resilient`` observer protocol
(or a serving loop's ``on_step``) and evaluates its rules on a check
cadence:

=============================  ============================================
rule                           fires when
=============================  ============================================
:class:`TTFTRule`              serving time-to-first-token over its
                               deadline (``serve/ttft_ms``; critical past
                               2x)
:class:`QueueDepthRule`        the admission queue backs up past a depth
                               budget (``serve/queue_depth``)
:class:`QueueWaitFractionRule` the TTFT attribution's queue-wait share
                               exceeds a budget (admission starved)
:class:`SpecAcceptanceRule`    the speculative acceptance rate sinks under
                               its floor (``serve/spec_accept_rate``)
:class:`ServeFaultRule`        the serving failure ledger moved (engine
                               faults and rebuilds, poisoned quarantines —
                               critical — decode timeouts, exhausted
                               retries, admission and allocation faults)
:class:`StaleFetchRule`        the registry's fetched values fall further
                               behind the live step than the cadence
                               explains
:class:`HungStepRule`          a step interval exceeds a wall-clock
                               deadline
=============================  ============================================

:func:`serve_rules` builds the serving set.  Every firing emits a
:class:`HealthEvent` to the watchdog's ``events``, the board
(``health/<rule>``), an attached flight recorder and span recorder, and
the ``on_unhealthy`` callback, and to a
:class:`~apex_tpu_torch.observability.export.Reporter`'s sinks as one
bench-schema record (``reporter=``).  The training and goodput rules
wait for ROADMAP item 8's next part.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = [
    "HealthEvent",
    "Rule",
    "StaleFetchRule",
    "HungStepRule",
    "TTFTRule",
    "QueueDepthRule",
    "QueueWaitFractionRule",
    "SpecAcceptanceRule",
    "ServeFaultRule",
    "serve_rules",
    "Watchdog",
]


class HealthEvent(NamedTuple):
    """One structured health finding."""

    rule: str  # e.g. "straggler", "mfu_floor"
    severity: str  # "warn" | "critical"
    step: int
    value: float  # the measurement that tripped the rule
    threshold: float  # what it was compared against
    message: str
    host: Optional[int] = None  # per-host rules name the offender

    def as_record(self) -> Dict[str, Any]:
        """Extras for a bench-schema Reporter line."""
        rec = {
            "severity": self.severity,
            "threshold": self.threshold,
            "message": self.message,
        }
        if self.host is not None:
            rec["host"] = self.host
        return rec


class Rule:
    """Base: named check + a repeat cooldown (steps) so a persistent
    condition emits on a heartbeat, not every check."""

    name = "rule"
    severity = "warn"

    def __init__(self, cooldown: int = 64):
        self.cooldown = cooldown
        self._last_fired: Optional[int] = None

    def check(self, wd: "Watchdog", step: int) -> List[HealthEvent]:
        if (
            self._last_fired is not None
            and step - self._last_fired < self.cooldown
        ):
            return []
        events = self.evaluate(wd, step)
        if events:
            self._last_fired = step
        return events

    def evaluate(self, wd: "Watchdog", step: int) -> List[HealthEvent]:
        raise NotImplementedError

    def _event(self, step, value, threshold, message, host=None):
        return [
            HealthEvent(
                self.name, self.severity, int(step), float(value),
                float(threshold), message, host,
            )
        ]


class StaleFetchRule(Rule):
    """The metric fetch pipeline wedged: fetched values lag the live
    step beyond what the double-buffered cadence explains (default
    budget: ``4 * fetch_every``)."""

    name = "stale_fetch"

    def __init__(self, max_age_steps: Optional[int] = None,
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.max_age_steps = max_age_steps

    def evaluate(self, wd, step):
        reg = wd.registry
        if reg is None:
            return []
        budget = (
            self.max_age_steps
            if self.max_age_steps is not None
            else 4 * reg.fetch_every
        )
        fetched = reg.fetched_step
        age = step - (fetched if fetched is not None else wd.first_step)
        if age > budget:
            return self._event(
                step, age, budget,
                f"metric fetch {age} steps stale (budget {budget}; "
                f"fetched_step={fetched})",
            )
        return []


class HungStepRule(Rule):
    """A step interval blew through a wall-clock deadline — the shape
    of a hung collective or a wedged host that eventually recovered.
    For a step that never completes, call :meth:`Watchdog.poll` from
    outside the loop (another thread, a signal handler)."""

    name = "hung_step"
    severity = "critical"

    def __init__(self, deadline_s: float = 300.0, cooldown: int = 1):
        super().__init__(cooldown)
        self.deadline_s = deadline_s

    def evaluate(self, wd, step):
        dt = wd.last_step_seconds
        if dt is not None and dt > self.deadline_s:
            return self._event(
                step, dt, self.deadline_s,
                f"step took {dt:.1f}s (deadline {self.deadline_s:.0f}s)",
            )
        return []


class TTFTRule(Rule):
    """Serving time-to-first-token over its deadline — tail latency is
    regressing at the front door.  Reads the ``serve/ttft_ms`` gauge
    the :class:`apex_tpu_torch.serve.scheduler.ContinuousBatchingScheduler`
    publishes on every admission; like :class:`LossSpikeRule`, only a
    freshly fetched value is judged (stale reads between cadences
    neither re-trigger nor mask).  Critical at ``critical_factor`` x
    the deadline."""

    name = "ttft"

    def __init__(self, deadline_ms: float = 1000.0,
                 key: str = "serve/ttft_ms",
                 critical_factor: float = 2.0, cooldown: int = 64):
        super().__init__(cooldown)
        self.deadline_ms = deadline_ms
        self.key = key
        self.critical_factor = critical_factor
        self._last_fetched: Optional[int] = None

    def evaluate(self, wd, step):
        reg = wd.registry
        if reg is None:
            return []
        fetched = reg.fetched_step
        if fetched is None or fetched == self._last_fetched:
            return []
        value = reg.values().get(self.key)
        if value is None:
            return []
        self._last_fetched = fetched
        if value > self.deadline_ms:
            severity = (
                "critical"
                if value > self.critical_factor * self.deadline_ms
                else "warn"
            )
            return [
                HealthEvent(
                    self.name, severity, int(step), float(value),
                    float(self.deadline_ms),
                    f"TTFT {value:.1f}ms over deadline "
                    f"{self.deadline_ms:.0f}ms",
                )
            ]
        return []


class QueueDepthRule(Rule):
    """The serving admission queue backing up past a depth budget —
    arrivals outpace capacity and TTFT is about to follow.  Reads the
    ``serve/queue_depth`` gauge; sustained depth re-emits on the
    cooldown heartbeat like every rule."""

    name = "queue_depth"

    def __init__(self, max_depth: int = 16,
                 key: str = "serve/queue_depth", cooldown: int = 64):
        super().__init__(cooldown)
        self.max_depth = max_depth
        self.key = key

    def evaluate(self, wd, step):
        reg = wd.registry
        if reg is None:
            return []
        value = reg.values().get(self.key)
        if value is None:
            return []
        if value > self.max_depth:
            return self._event(
                step, value, self.max_depth,
                f"admission queue depth {value:.0f} over budget "
                f"{self.max_depth} (arrivals outpacing decode capacity)",
            )
        return []


class QueueWaitFractionRule(Rule):
    """TTFT dominated by **queue wait** — admission is starved (slots
    or pages), not the prefill program: adding compute to the decode
    path cannot help; the levers are pool size, batch slots, and
    shedding policy.  Reads the ``serve/ttft_queue_wait_fraction``
    gauge the scheduler's TTFT attribution publishes over its recent
    completion window; like :class:`TTFTRule`, only a freshly fetched value is
    judged."""

    name = "queue_wait_fraction"

    def __init__(self, max_fraction: float = 0.5,
                 key: str = "serve/ttft_queue_wait_fraction",
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.max_fraction = max_fraction
        self.key = key
        self._last_fetched: Optional[int] = None

    def evaluate(self, wd, step):
        reg = wd.registry
        if reg is None:
            return []
        fetched = reg.fetched_step
        if fetched is None or fetched == self._last_fetched:
            return []
        value = reg.values().get(self.key)
        if value is None:
            return []
        self._last_fetched = fetched
        if value > self.max_fraction:
            return self._event(
                step, value, self.max_fraction,
                f"queue wait is {value:.0%} of TTFT (budget "
                f"{self.max_fraction:.0%}) — admission starved: grow "
                "the page pool / decode slots or shed earlier",
            )
        return []


class SpecAcceptanceRule(Rule):
    """Speculative-decoding acceptance rate under its floor — the
    draft model has drifted from the target (stale draft weights after
    a redeploy, a poisoned draft cache) and every rejected token is a
    wasted draft step plus a rollback.  Reads the
    ``serve/spec_accept_rate`` gauge the scheduler publishes over its
    acceptance window; the scheduler's own degradation ladder falls back to plain decode
    below ``SpecConfig.min_accept_rate`` — this rule pages BEFORE that
    cliff so an operator can ship a better draft first.  Emits only
    when speculation actually ran (a zero-drafted window publishes
    rate 0.0 — judged only if the ``serve/spec_rounds`` counter is
    nonzero); like :class:`TTFTRule`, only a freshly fetched value is
    judged."""

    name = "spec_acceptance"

    def __init__(self, min_rate: float = 0.5,
                 key: str = "serve/spec_accept_rate",
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.min_rate = min_rate
        self.key = key
        self._last_fetched: Optional[int] = None

    def evaluate(self, wd, step):
        reg = wd.registry
        if reg is None:
            return []
        fetched = reg.fetched_step
        if fetched is None or fetched == self._last_fetched:
            return []
        vals = reg.values()
        value = vals.get(self.key)
        if value is None or not vals.get("serve/spec_rounds"):
            return []
        self._last_fetched = fetched
        if value < self.min_rate:
            return self._event(
                step, value, self.min_rate,
                f"spec acceptance {value:.0%} under floor "
                f"{self.min_rate:.0%} — draft/target drift: redeploy "
                "the draft or lower k before the fallback ladder "
                "disables speculation",
            )
        return []


class ServeFaultRule(Rule):
    """The serving failure ledger moved (the scheduler's retries,
    supervision and overload ladder): engine faults and supervised
    rebuilds, poisoned-request quarantines, per-request decode
    timeouts, exhausted re-admission retries.  Each watched counter
    that increased since the last fetch emits one event carrying the
    delta — a recovered fault is WORKING AS DESIGNED but must never be
    invisible.  Poisoned quarantines page critical (non-finite logits
    mean numerics corruption upstream of the scheduler); everything
    else warns."""

    name = "serve_faults"

    #: counter -> severity when it moves
    WATCHED = (
        ("serve/engine_faults", "warn"),
        ("serve/engine_rebuilds", "warn"),
        ("serve/shed_poisoned", "critical"),
        ("serve/decode_timeouts", "warn"),
        ("serve/shed_retries_exhausted", "warn"),
        ("serve/admission_faults", "warn"),
        ("serve/kv_alloc_faults", "warn"),
    )

    def __init__(self, cooldown: int = 0):
        super().__init__(cooldown)
        self._last: Dict[str, float] = {}
        self._last_fetched: Optional[int] = None

    def evaluate(self, wd, step):
        reg = wd.registry
        if reg is None:
            return []
        fetched = reg.fetched_step
        if fetched is None or fetched == self._last_fetched:
            return []
        self._last_fetched = fetched
        values = reg.values()
        events = []
        for key, severity in self.WATCHED:
            value = values.get(key)
            if value is None:
                continue
            prev = self._last.get(key, 0.0)
            self._last[key] = float(value)
            delta = float(value) - prev
            if delta <= 0:
                continue
            events.append(
                HealthEvent(
                    self.name, severity, int(step), float(value),
                    prev,
                    f"{key} advanced by {delta:.0f} (now {value:.0f}) — "
                    "a fault was absorbed by the serving recovery "
                    "machinery; check the span timeline for the "
                    "retrying/shed chains",
                )
            )
        return events


def serve_rules(**overrides) -> List[Rule]:
    """The serving-path rule set: TTFT deadline, queue-depth budget,
    queue-wait-fraction attribution, speculative acceptance and the
    failure ledger, plus the substrate rules of any long-running device
    loop (stale fetch, hung step).  Keyword args override a rule's
    kwargs by name, e.g. ``serve_rules(ttft={"deadline_ms": 250.0})``."""
    specs = {
        "ttft": TTFTRule,
        "queue_depth": QueueDepthRule,
        "queue_wait_fraction": QueueWaitFractionRule,
        "spec_acceptance": SpecAcceptanceRule,
        "serve_faults": ServeFaultRule,
        "stale_fetch": StaleFetchRule,
        "hung_step": HungStepRule,
    }
    unknown = set(overrides) - set(specs)
    if unknown:
        raise ValueError(f"unknown serve health rules: {sorted(unknown)}")
    return [cls(**overrides.get(name, {})) for name, cls in specs.items()]


class Watchdog:
    """Evaluate health rules on a cadence; emit structured events.

    Implements the ``run_resilient`` observer protocol, so wiring is
    one entry in the observer fan-out::

        wd = Watchdog(serve_rules(), registry=reg, flight=recorder,
                      on_unhealthy=lambda ev: page(ev))
        run_resilient(..., observer=ObserverFanout([obs, wd]))

    ``rules`` defaults to :func:`serve_rules` (the training rules wait
    for ROADMAP item 8's next part).  A broken rule must not kill the loop: rule
    exceptions are caught, warned once per rule, and the rule is
    disabled for the run.
    """

    def __init__(
        self,
        rules: Optional[List[Rule]] = None,
        *,
        registry=None,
        reporter=None,
        flight=None,
        spans=None,
        on_unhealthy: Optional[Callable[[HealthEvent], Any]] = None,
        check_every: int = 8,
        window: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        self.rules = list(rules) if rules is not None else serve_rules()
        self.registry = registry
        #: optional :class:`~apex_tpu_torch.observability.export.Reporter`
        #: whose sinks get every firing as a bench-schema record
        self.reporter = reporter
        self.flight = flight
        #: optional :class:`~apex_tpu_torch.observability.spans.SpanRecorder`
        #: — every firing lands on its health track, so the merged
        #: timeline shows the alert next to the spans that explain it
        self.spans = spans
        self.on_unhealthy = on_unhealthy
        self.check_every = check_every
        self.events: List[HealthEvent] = []
        self.skip_window: collections.deque = collections.deque(
            maxlen=window
        )
        self.first_step = 0
        self._seen_step = False
        self._step = 0
        self._clock = clock
        self._last_tick: Optional[float] = None
        self.last_step_seconds: Optional[float] = None
        self._broken: set = set()

    # -- observer protocol -------------------------------------------------
    def on_step(self, step: int, skipped: bool = False, info=None) -> None:
        step = int(step)
        if not self._seen_step:
            self.first_step = step
            self._seen_step = True
        self._step = step
        now = self._clock()
        if self._last_tick is not None:
            self.last_step_seconds = now - self._last_tick
        self._last_tick = now
        self.skip_window.append(bool(skipped))
        if step % self.check_every == 0:
            self.check(step)

    def on_rollback(self, step, anchor, skips=0, discarded=None) -> None:
        # the replay re-executes the window; a stale skip history would
        # double-count the streak the rollback just handled
        self.skip_window.clear()

    def on_resume(self, step: int) -> None:
        self.first_step = int(step)

    # -- evaluation --------------------------------------------------------
    def check(self, step: Optional[int] = None) -> List[HealthEvent]:
        """Run every rule now; returns (and emits) new events."""
        step = self._step if step is None else int(step)
        fired: List[HealthEvent] = []
        for rule in self.rules:
            if rule.name in self._broken:
                continue
            try:
                fired.extend(rule.check(self, step))
            except Exception as e:  # a telemetry bug must not kill training
                self._broken.add(rule.name)
                warnings.warn(
                    f"health rule {rule.name!r} raised "
                    f"{type(e).__name__}: {e} — disabled for this run",
                    RuntimeWarning,
                )
        for event in fired:
            self._emit(event)
        return fired

    def poll(self) -> List[HealthEvent]:
        """External deadline check — call from a monitor thread or a
        dump path to catch a step that is hung *right now* (the in-loop
        rules only see completed intervals).

        Honors the rule's cooldown and broken-set exactly like
        :meth:`check`: the step counter does not advance during a hang,
        so a once-per-second monitor loop emits ONE event per hung
        step, not one per poll.
        """
        fired: List[HealthEvent] = []
        if self._last_tick is not None:
            waiting = self._clock() - self._last_tick
            for rule in self.rules:
                if not isinstance(rule, HungStepRule):
                    continue
                if rule.name in self._broken:
                    continue
                if (
                    rule._last_fired is not None
                    and self._step - rule._last_fired < rule.cooldown
                ):
                    continue
                if waiting > rule.deadline_s:
                    rule._last_fired = self._step
                    fired.extend(
                        rule._event(
                            self._step, waiting, rule.deadline_s,
                            f"step {self._step + 1} hung for "
                            f"{waiting:.1f}s (deadline "
                            f"{rule.deadline_s:.0f}s)",
                        )
                    )
        for event in fired:
            self._emit(event)
        return fired

    # -- emission ----------------------------------------------------------
    def _emit(self, event: HealthEvent) -> None:
        self.events.append(event)
        from apex_tpu_torch.observability.metrics import board

        board.set(f"health/{event.rule}", event.value)
        if self.reporter is not None:
            from apex_tpu_torch.observability.export import bench_record

            rec = bench_record(
                f"health/{event.rule}", event.value, "", None,
                step=event.step, **event.as_record(),
            )
            for sink in self.reporter.sinks:
                sink.write(rec)
        if self.flight is not None:
            self.flight.note_health(event)
        if self.spans is not None:
            self.spans.note_health(event)
        if self.on_unhealthy is not None:
            try:
                self.on_unhealthy(event)
            except Exception as e:
                warnings.warn(
                    f"on_unhealthy callback raised {type(e).__name__}: {e}",
                    RuntimeWarning,
                )
