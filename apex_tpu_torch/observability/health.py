"""Fleet health watchdog — declarative rules over live telemetry.

Counterpart of ``apex_tpu/observability/health.py``, host code copied
over: every rule, :func:`default_rules`, :func:`goodput_rules`,
:func:`serve_rules` and :class:`Watchdog` with its ``meter=``,
``goodput=``, ``fleet=`` and ``attribution=`` inputs.

A production fleet does not fail loudly: it gets *slow* (one straggling
host gates every collective), *wasteful* (goodput decays as a flaky
guard skips), or *stale* (a hung collective stops the metric fetch
pipeline while the process looks alive).  :class:`Watchdog` rides the
``run_resilient`` observer protocol and evaluates a small declarative
rule set on a check cadence:

========================  =================================================
rule                      fires when
========================  =================================================
:class:`StragglerRule`    a host's step time z-scores above the fleet
                          (needs a :class:`~apex_tpu_torch.observability.fleet.
                          FleetAggregator` view)
:class:`MFUFloorRule`     the live MFU sinks under a floor after warmup
:class:`GoodputFloorRule` the goodput fraction sinks under a floor
:class:`LossSpikeRule`    the fetched loss goes non-finite (critical) or
                          spikes over ``factor`` x its own EMA
:class:`NaNRateRule`      the skip rate over a sliding window exceeds a
                          budget (a NaN *storm*, not one bad batch)
:class:`StaleFetchRule`   the registry's fetched values fall further
                          behind the live step than the cadence explains
:class:`HungStepRule`     a step interval exceeds a wall-clock deadline
                          (a hung/slow collective that eventually
                          completed); :meth:`Watchdog.poll` covers the
                          still-hung case from an external thread
:class:`CollectiveFractionRule` the step-time attribution's collective
                          share exceeds a floor (comm-bound: the next
                          lever is wire format/overlap, not kernels)
:class:`HostStallRule`    the attribution's host-stall share exceeds a
                          floor (the chip is starving, not slow)
:class:`MemoryBudgetRule` the graph linter's static peak-HBM estimate
                          (``analysis/peak_hbm_bytes``) crosses the
                          deployment budget — opt-in (needs the budget)
:class:`TTFTRule`         serving time-to-first-token over its SLO
                          deadline (``serve/ttft_ms`` gauge; critical
                          past 2x) — :func:`serve_rules` only
:class:`QueueDepthRule`   the serving admission queue backs up past a
                          depth budget (``serve/queue_depth``) —
                          :func:`serve_rules` only
:class:`QueueWaitFractionRule` the TTFT attribution's queue-wait share
                          exceeds a budget (admission starved —
                          ``serve/ttft_queue_wait_fraction``) —
                          :func:`serve_rules` only
:class:`ServeFaultRule`   the serving failure ledger moved — engine
                          faults/rebuilds, poisoned quarantines
                          (critical), decode timeouts, exhausted
                          retries — :func:`serve_rules` only
========================  =================================================

Training loops use :func:`default_rules`; the serving path
(:mod:`apex_tpu_torch.serve`) uses :func:`serve_rules` — TTFT/queue-depth
plus the substrate rules (stale fetch, hung step) — so tail-latency
regressions page the SAME health layer training uses
(``docs/serving.md``).

The fleet control plane and its canary-gated deploys emit events
through the same type without a rule class: ``fleet_*`` events come
straight from :class:`~apex_tpu_torch.fleetctl.Fleet` (crash/preempt/eject/
scale/deploy), and the canary gate adds ``fleet_canary_fingerprint``
(old→new probe distance on a weight swap), ``fleet_canary_verdict``
(the pass/fail drift verdict — critical on fail, which also triggers
``fleet_deploy_rollback``), and ``fleet_canary_inconclusive`` (window
expired under the min-sample floor; the deploy proceeds UNPROVEN).
See :mod:`apex_tpu_torch.observability.canary`.

The two fraction rules read the step-time attribution published by
:func:`~apex_tpu_torch.observability.attribution.publish_attribution` —
either an object handed to ``Watchdog(attribution=...)`` or the board
keys ``attribution/collective_fraction`` /
``attribution/host_stall_fraction`` (how ``tools/step_profile.py`` and
the resilient example feed them).

Every firing emits a structured :class:`HealthEvent` to: the watchdog's
``events`` ledger, the observability board (``health/<rule>``), the
Reporter sinks (bench-schema lines with ``severity``/``message``/
``host`` extras), the flight recorder's event log, the span
recorder's health track (``Watchdog(spans=...)`` — the alert lands on
the merged timeline next to the spans that explain it), and the
``on_unhealthy`` callback — which is the escalation hook: pass a
callback that arms a :class:`~apex_tpu_torch.observability.trace.
TraceScheduler` window and an alert turns into an on-chip profile in
the same run.  See ``docs/observability.md``.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = [
    "HealthEvent",
    "Rule",
    "StragglerRule",
    "MFUFloorRule",
    "GoodputFloorRule",
    "LossSpikeRule",
    "NaNRateRule",
    "StaleFetchRule",
    "HungStepRule",
    "CollectiveFractionRule",
    "HostStallRule",
    "MemoryBudgetRule",
    "CheckpointStallRule",
    "InputStallRule",
    "TTFTRule",
    "QueueDepthRule",
    "QueueWaitFractionRule",
    "SpecAcceptanceRule",
    "ServeFaultRule",
    "default_rules",
    "goodput_rules",
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


class StragglerRule(Rule):
    """A host whose step time z-scores above the rest of the fleet.

    Leave-one-out: each host is scored against the mean/std of the
    OTHER hosts — a pooled std would let one extreme outlier inflate
    the denominator and hide itself (one 4x straggler among 8 hosts
    pools to z≈2.7).  ``std`` is floored at ``rel_floor * mean`` so a
    fleet in lockstep (std ~ 0) does not turn micro-jitter into
    alerts.
    """

    name = "straggler"

    def __init__(self, zmax: float = 3.0, key: str = "train/step_time_ms",
                 rel_floor: float = 0.05, min_hosts: int = 2,
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.zmax = zmax
        self.key = key
        self.rel_floor = rel_floor
        self.min_hosts = min_hosts

    def evaluate(self, wd, step):
        view = wd.fleet_view
        if view is None or view.hosts < self.min_hosts:
            return []
        if self.key not in view.names:
            return []
        vals = view.per_host(self.key)
        labels = view.labels
        events = []
        for row, v in enumerate(vals):
            if v != v:
                continue
            others = [o for j, o in enumerate(vals) if j != row and o == o]
            if len(others) < self.min_hosts - 1:
                continue
            mean = sum(others) / len(others)
            var = sum((o - mean) ** 2 for o in others) / len(others)
            std = max(var ** 0.5, self.rel_floor * abs(mean), 1e-12)
            z = (v - mean) / std
            if z > self.zmax:
                host = labels[row]
                events.extend(
                    self._event(
                        step, v, mean + self.zmax * std,
                        f"host {host} straggling: {self.key}={v:.3f} "
                        f"(fleet mean {mean:.3f}, z={z:.1f})",
                        host=host,
                    )
                )
        return events


class MFUFloorRule(Rule):
    """Live MFU under a floor once the meter window has warmed up."""

    name = "mfu_floor"

    def __init__(self, floor: float = 0.05, warmup_steps: int = 16,
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.floor = floor
        self.warmup_steps = warmup_steps

    def evaluate(self, wd, step):
        meter = wd.meter
        if meter is None or meter.flops_per_step <= 0:
            return []
        if meter.steps < self.warmup_steps:
            return []
        mfu = meter.mfu
        if 0.0 < mfu < self.floor:
            return self._event(
                step, mfu, self.floor,
                f"MFU {mfu:.4f} under floor {self.floor:.4f}",
            )
        return []


class GoodputFloorRule(Rule):
    """Productive fraction under a floor after enough executed steps."""

    name = "goodput_floor"

    def __init__(self, floor: float = 0.5, min_executed: int = 20,
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.floor = floor
        self.min_executed = min_executed

    def evaluate(self, wd, step):
        acct = wd.goodput
        if acct is None or acct.executed < self.min_executed:
            return []
        g = acct.goodput()
        if g < self.floor:
            return self._event(
                step, g, self.floor,
                f"goodput {g:.3f} under floor {self.floor:.3f} "
                f"(skipped={acct.skipped}, discarded={acct.discarded})",
            )
        return []


class LossSpikeRule(Rule):
    """Fetched loss non-finite (critical) or > ``factor`` x its EMA.

    The EMA folds each *newly fetched* loss value (tracked via the
    registry's ``fetched_step``), so the stale reads between cadences
    neither re-trigger nor re-teach the baseline.
    """

    name = "loss_spike"

    def __init__(self, key: str = "train/loss", factor: float = 10.0,
                 ema_beta: float = 0.9, warmup_fetches: int = 3,
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.key = key
        self.factor = factor
        self.ema_beta = ema_beta
        self.warmup_fetches = warmup_fetches
        self._ema: Optional[float] = None
        self._fetches = 0
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
        if value != value or value in (float("inf"), float("-inf")):
            return [
                HealthEvent(
                    self.name, "critical", int(step), float("nan"),
                    0.0, f"{self.key} non-finite at fetch {fetched}",
                )
            ]
        events = []
        if (
            self._ema is not None
            and self._fetches >= self.warmup_fetches
            and value > self.factor * self._ema
        ):
            events = self._event(
                step, value, self.factor * self._ema,
                f"{self.key}={value:.4g} spiked over {self.factor}x "
                f"EMA {self._ema:.4g}",
            )
            # a spike must not re-teach the baseline
            return events
        self._ema = (
            value if self._ema is None
            else self.ema_beta * self._ema + (1 - self.ema_beta) * value
        )
        self._fetches += 1
        return events


class NaNRateRule(Rule):
    """Skip *rate* over a sliding window — a storm, not one bad batch."""

    name = "nan_rate"

    def __init__(self, max_rate: float = 0.25, window: int = 16,
                 cooldown: int = 64):
        super().__init__(cooldown)
        self.max_rate = max_rate
        self.window = window

    def evaluate(self, wd, step):
        skips = wd.skip_window
        if len(skips) < self.window:
            return []
        recent = list(skips)[-self.window:]
        rate = sum(recent) / len(recent)
        if rate > self.max_rate:
            return self._event(
                step, rate, self.max_rate,
                f"skip rate {rate:.2f} over last {self.window} steps "
                f"exceeds {self.max_rate:.2f}",
            )
        return []


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


class _AttributionFractionRule(Rule):
    """Base for rules over the step-time attribution fractions
    (:mod:`apex_tpu_torch.observability.attribution`).  The fraction comes
    from ``Watchdog(attribution=...)`` — an object with
    ``fractions()`` or a plain mapping — or, failing that, the board
    key ``attribution/<key>_fraction`` that
    :func:`~apex_tpu_torch.observability.attribution.publish_attribution`
    sets.  No attribution anywhere → the rule is silent (it cannot
    invent a decomposition)."""

    key = "collective"

    def __init__(self, max_fraction: float, cooldown: int = 64):
        super().__init__(cooldown)
        self.max_fraction = max_fraction

    def _fraction(self, wd) -> Optional[float]:
        src = getattr(wd, "attribution", None)
        if src is not None:
            fr = src.fractions() if hasattr(src, "fractions") else src
            val = fr.get(self.key)
            return float(val) if val is not None else None
        from apex_tpu_torch.observability.metrics import board

        val = board.get(f"attribution/{self.key}_fraction")
        return float(val) if val is not None else None

    def evaluate(self, wd, step):
        frac = self._fraction(wd)
        if frac is not None and frac > self.max_fraction:
            return self._event(
                step, frac, self.max_fraction,
                f"{self.key} fraction {frac:.3f} of step time exceeds "
                f"{self.max_fraction:.3f} ({self.diagnosis})",
            )
        return []


class CollectiveFractionRule(_AttributionFractionRule):
    """Comm share of the step over a floor — the step is comm-bound:
    tune wire formats / chunked overlap (docs/comm.md) before
    kernels."""

    name = "collective_fraction"
    key = "collective"
    diagnosis = "comm-bound: next lever is wire format/overlap"

    def __init__(self, max_fraction: float = 0.35, cooldown: int = 64):
        super().__init__(max_fraction, cooldown)


class HostStallRule(_AttributionFractionRule):
    """Host-stall share of the step over a floor — the chip is
    starving (dispatch latency, blocked fetches, input waits), not
    slow; faster kernels cannot help."""

    name = "host_stall"
    key = "host_stall"
    diagnosis = "chip starving: dispatch/input path, not kernels"

    def __init__(self, max_fraction: float = 0.15, cooldown: int = 64):
        super().__init__(max_fraction, cooldown)


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
    completion window (``docs/observability.md`` "Request tracing &
    timeline"); like :class:`TTFTRule`, only a freshly fetched value is
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
    acceptance window (``docs/serving.md`` "Speculative decoding");
    the scheduler's own degradation ladder falls back to plain decode
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
    """The serving failure ledger moved (docs/serving.md "Failure
    semantics & degradation ladder"): engine faults and supervised
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


class MemoryBudgetRule(Rule):
    """The static peak-HBM estimate published by the graph linter
    (``analysis/peak_hbm_bytes`` — :func:`apex_tpu_torch.analysis.memory
    .publish_peak`, also republished when a program recompiles
    mid-run) crosses the deployment's budget: critical when over it
    (the NEXT recompile OOMs), warn when inside ``warn_fraction`` of
    it (one batch-size bump from the cliff).  Budget-less
    construction is an error — a watchdog cannot guess how much HBM
    the deployment reserved, which is why this rule is opt-in rather
    than in :func:`default_rules`."""

    name = "memory_budget"
    severity = "critical"

    def __init__(self, budget_bytes: int, warn_fraction: float = 0.9,
                 key: str = "analysis/peak_hbm_bytes",
                 cooldown: int = 512):
        if not budget_bytes or budget_bytes <= 0:
            raise ValueError("MemoryBudgetRule needs a positive budget")
        super().__init__(cooldown)
        self.budget_bytes = int(budget_bytes)
        self.warn_fraction = warn_fraction
        self.key = key

    def evaluate(self, wd, step):
        from apex_tpu_torch.observability.metrics import board

        peak = board.get(self.key)
        if peak is None:
            return []
        peak = float(peak)
        mib = 1 << 20
        if peak > self.budget_bytes:
            return self._event(
                step, peak, self.budget_bytes,
                f"static peak HBM {peak / mib:.1f} MiB exceeds the "
                f"{self.budget_bytes / mib:.1f} MiB budget — the next "
                "(re)compile OOMs; see tools/shard_report.py for the "
                "per-buffer attribution",
            )
        if peak > self.warn_fraction * self.budget_bytes:
            ev = self._event(
                step, peak, self.warn_fraction * self.budget_bytes,
                f"static peak HBM {peak / mib:.1f} MiB is inside "
                f"{1 - self.warn_fraction:.0%} of the "
                f"{self.budget_bytes / mib:.1f} MiB budget",
            )
            return [ev[0]._replace(severity="warn")]
        return []


class CheckpointStallRule(Rule):
    """The checkpoint engine's step-path stall fraction
    (``goodput/ckpt/stall_frac``, published by
    :class:`apex_tpu_torch.goodput.AsyncCheckpointEngine` on every save —
    snapshot + enqueue wait over wall time, background write time
    excluded) crosses the overhead budget.  The default 1% is the
    GOODPUT acceptance bar (docs/goodput.md): above it the "zero
    stall" contract is broken — typically the writer falling behind
    the save cadence, so the bounded queue's backpressure has reached
    the step path.  Critical at 2x the budget."""

    name = "ckpt_stall"
    severity = "warn"

    def __init__(self, max_fraction: float = 0.01, cooldown: int = 128):
        super().__init__(cooldown)
        self.max_fraction = max_fraction

    def evaluate(self, wd, step):
        from apex_tpu_torch.observability.metrics import board

        frac = board.get("goodput/ckpt/stall_frac")
        if frac is None or float(frac) <= self.max_fraction:
            return []
        frac = float(frac)
        ev = self._event(
            step, frac, self.max_fraction,
            f"checkpoint stall fraction {frac:.4f} over the "
            f"{self.max_fraction:.2%} budget — the background writer "
            "is not keeping up with the save cadence (backpressure "
            "reached the step path); lengthen save_interval_steps or "
            "speed up storage",
        )
        if frac > 2 * self.max_fraction:
            return [ev[0]._replace(severity="critical")]
        return ev


class InputStallRule(Rule):
    """The input pipeline's stall fraction
    (``data/input_stall_fraction``, published by
    :class:`apex_tpu_torch.data.DevicePrefetcher` — consumer time blocked on
    an empty prefetch queue over wall time) crosses ``max_fraction``:
    the chip is data-starved.  Cross-check against the attribution
    layer's host-stall bucket (``attribution/host_stall_fraction`` — docs/
    observability.md "Attribution & roofline"): input stall without
    host stall means the gap is hidden by dispatch depth; both high
    means the loader genuinely gates the step."""

    name = "input_stall"
    severity = "warn"

    def __init__(self, max_fraction: float = 0.15, cooldown: int = 128):
        super().__init__(cooldown)
        self.max_fraction = max_fraction

    def evaluate(self, wd, step):
        from apex_tpu_torch.observability.metrics import board

        frac = board.get("data/input_stall_fraction")
        if frac is None or float(frac) <= self.max_fraction:
            return []
        frac = float(frac)
        # the key publish_attribution actually writes (attribution.py)
        host_stall = board.get("attribution/host_stall_fraction")
        xref = (
            f" (attribution host-stall bucket reads {float(host_stall):.3f})"
            if host_stall is not None else ""
        )
        return self._event(
            step, frac, self.max_fraction,
            f"input-stall fraction {frac:.3f} over {self.max_fraction:.2f}"
            f" — the step consumer is blocking on the prefetch queue; "
            f"raise the prefetch depth or feed from faster storage{xref}",
        )


def goodput_rules(floor: float = 0.99, **overrides) -> List[Rule]:
    """The preemptible-fleet rule set (docs/goodput.md): the goodput
    floor at the deployment bar (default 99% — the storm-drill
    acceptance number), checkpoint stall over budget, input
    starvation, plus the substrate rules.  Same override convention as
    :func:`default_rules`."""
    specs = {
        "goodput_floor": GoodputFloorRule,
        "ckpt_stall": CheckpointStallRule,
        "input_stall": InputStallRule,
        "stale_fetch": StaleFetchRule,
        "hung_step": HungStepRule,
    }
    unknown = set(overrides) - set(specs)
    if unknown:
        raise ValueError(f"unknown goodput health rules: {sorted(unknown)}")
    # merge, not setdefault: goodput_rules(floor=0.999,
    # goodput_floor={"cooldown": 64}) must keep the explicit floor (an
    # override dict that names "floor" itself still wins)
    overrides["goodput_floor"] = {
        "floor": floor, **overrides.get("goodput_floor", {})
    }
    return [cls(**overrides.get(name, {})) for name, cls in specs.items()]


def serve_rules(**overrides) -> List[Rule]:
    """The serving-path rule set (``docs/serving.md``): TTFT deadline,
    queue-depth budget, queue-wait-fraction attribution, plus the
    substrate rules that apply to any long-running device loop (stale
    fetch, hung step).  Same override convention as
    :func:`default_rules`, e.g.
    ``serve_rules(ttft={"deadline_ms": 250.0})``."""
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


def default_rules(**overrides) -> List[Rule]:
    """The standard rule set; keyword args override a rule's kwargs by
    name, e.g. ``default_rules(straggler={"zmax": 2.5})``."""
    specs = {
        "straggler": StragglerRule,
        "mfu_floor": MFUFloorRule,
        "goodput_floor": GoodputFloorRule,
        "loss_spike": LossSpikeRule,
        "nan_rate": NaNRateRule,
        "stale_fetch": StaleFetchRule,
        "hung_step": HungStepRule,
        "collective_fraction": CollectiveFractionRule,
        "host_stall": HostStallRule,
    }
    unknown = set(overrides) - set(specs)
    if unknown:
        raise ValueError(f"unknown health rules: {sorted(unknown)}")
    return [cls(**overrides.get(name, {})) for name, cls in specs.items()]


class Watchdog:
    """Evaluate health rules on a cadence; emit structured events.

    Implements the ``run_resilient`` observer protocol, so wiring is
    one entry in the observer fan-out::

        wd = Watchdog(registry=reg, meter=meter, goodput=acct,
                      reporter=reporter, flight=recorder,
                      on_unhealthy=lambda ev: tracer.arm(ev.step + 1, 3))
        run_resilient(..., observer=ObserverFanout([acct, wd]))

    A broken rule must not kill training: rule exceptions are caught,
    warned once per rule, and the rule is disabled for the run.
    """

    def __init__(
        self,
        rules: Optional[List[Rule]] = None,
        *,
        registry=None,
        meter=None,
        goodput=None,
        fleet=None,
        reporter=None,
        flight=None,
        spans=None,
        attribution=None,
        on_unhealthy: Optional[Callable[[HealthEvent], Any]] = None,
        check_every: int = 8,
        window: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        self.rules = list(rules) if rules is not None else default_rules()
        self.registry = registry
        self.meter = meter
        self.goodput = goodput
        self.fleet = fleet
        #: step-time attribution source for the fraction rules: an
        #: object with ``fractions()`` (Cost/TraceAttribution) or a
        #: plain mapping; None → rules fall back to the board keys
        self.attribution = attribution
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

    @property
    def fleet_view(self):
        return self.fleet.view() if self.fleet is not None else None

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
