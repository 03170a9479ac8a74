"""SLO objects + multi-window multi-burn-rate alerting.

Counterpart of ``apex_tpu/observability/slo.py``, host code copied over.

The health rules landed so far are point-in-time thresholds: "TTFT over
its deadline right now", "queue depth over budget right now".  A
production pager does not work that way — it pages on **error-budget
burn**: with an objective of 99.9% good events, the budget is 0.1% of
traffic per period, and the *burn rate* is how many times faster than
sustainable the service is currently spending it (burn 1.0 = exactly
exhausting the budget over the period; burn 14.4 over a 0.1% budget =
the classic "1h window eats 2% of a 30-day budget" page).  The Google
SRE workbook's refinement — fire only when BOTH a short and a long
window exceed the factor — is what keeps a 10-second blip from paging
while a sustained storm pages in minutes:

- the **long** window proves the burn is sustained (a blip dilutes);
- the **short** window proves it is *still happening* (alerts stop
  quickly after recovery instead of riding the long tail).

Pieces:

- :class:`SLO` / :class:`CounterRatioSLO` / :class:`LatencySLO` —
  declarative objectives over cumulative good/total event counts.
  Counter SLOs read registry counters (``serve/completed`` vs
  completed+shed); latency SLOs read a host-side
  :class:`~apex_tpu_torch.observability.ometrics.Histogram`'s cumulative
  buckets (good = observations ≤ the threshold bound — the classic
  Prometheus-histogram SLI).
- :class:`BurnRateTracker` — a bounded deque of ``(t, good, total)``
  cumulative samples recorded on the evaluation cadence;
  :meth:`burn_rate` computes the windowed error rate / error budget.
  A window reports ``None`` until its samples span at least half the
  window (cold-start honesty: extrapolating a 2-second-old process
  onto a 1-hour window manufactures pages).
- :class:`SLORule` — a :class:`~apex_tpu_torch.observability.health.Rule`,
  so SLO alerting rides the EXISTING Watchdog machinery: a firing
  emits a structured :class:`~apex_tpu_torch.observability.health
  .HealthEvent` to the board (``health/slo_<name>``), the Reporter
  sinks, the flight recorder, and the span recorder's health track —
  which is the point: an SLO page lands on the same merged timeline as
  the request spans that blew it (``tools/timeline.py``).
- :func:`serve_slo_rules` — the serving objective set (TTFT latency,
  request goodput, deadline-shed rate) ready to append to a serving
  watchdog's rules.

Evaluation happens on the watchdog's check cadence; counter sources
read the registry's *cached* values (fresh within the registry's
``2 × fetch_every`` contract), so a wedged fetch pipeline decays burn
toward 0 — which :class:`~apex_tpu_torch.observability.health.StaleFetchRule`
already alerts on.  See ``docs/observability.md`` ("Live ops plane").
"""

from __future__ import annotations

import collections
import time
from typing import (
    Deque, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple,
)

from apex_tpu_torch.observability.health import HealthEvent, Rule

__all__ = [
    "Window",
    "DEFAULT_WINDOWS",
    "SLO",
    "CounterRatioSLO",
    "LatencySLO",
    "BurnRateTracker",
    "SLORule",
    "serve_slo_rules",
    "FLEET_TERMINAL_SHED_KEYS",
    "fleet_slo_rules",
    "burn_rate_drill",
]


class Window(NamedTuple):
    """One multi-window burn-rate alert condition: fire when the burn
    over BOTH ``short_s`` and ``long_s`` exceeds ``factor``."""

    short_s: float
    long_s: float
    factor: float
    severity: str = "critical"


#: the Google SRE workbook's recommended pair for a 30-day budget:
#: page on 5m/1h at 14.4x (2% of budget in an hour), ticket on
#: 30m/6h at 6x (5% in six hours)
DEFAULT_WINDOWS = (
    Window(300.0, 3600.0, 14.4, "critical"),
    Window(1800.0, 21600.0, 6.0, "warn"),
)


class SLO:
    """Base: a named objective over cumulative good/total counts.

    ``objective`` is the target good fraction (0.999 = "99.9% of
    events good"); the error budget is ``1 - objective``.
    Subclasses implement :meth:`counts`.
    """

    def __init__(self, name: str, objective: float, description: str = ""):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}"
            )
        self.name = str(name)
        self.objective = float(objective)
        self.description = description

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def counts(self, values: Mapping[str, float]) -> Optional[
        Tuple[float, float]
    ]:
        """Cumulative ``(good, total)`` event counts, or ``None`` when
        the source has no data yet.  ``values`` is the registry's
        cached value mapping (latency SLOs ignore it — their histogram
        is bound at construction)."""
        raise NotImplementedError


class CounterRatioSLO(SLO):
    """Good/total from registry counters (each side a sum of keys).

    >>> CounterRatioSLO("goodput", 0.95,
    ...                 good_keys=("serve/completed",),
    ...                 total_keys=("serve/completed", "serve/shed"))
    """

    def __init__(self, name: str, objective: float, *,
                 good_keys: Iterable[str], total_keys: Iterable[str],
                 description: str = ""):
        super().__init__(name, objective, description)
        self.good_keys = tuple(good_keys)
        self.total_keys = tuple(total_keys)
        if not self.good_keys or not self.total_keys:
            raise ValueError("good_keys and total_keys must be non-empty")

    def counts(self, values):
        if not any(k in values for k in self.total_keys):
            return None
        good = sum(float(values.get(k, 0.0)) for k in self.good_keys)
        total = sum(float(values.get(k, 0.0)) for k in self.total_keys)
        return good, total


class LatencySLO(SLO):
    """Good = observations at or under ``threshold`` on a histogram.

    The threshold should sit ON a bucket bound
    (:meth:`~apex_tpu_torch.observability.ometrics.Histogram.count_le`
    truncates to the nearest lower bound otherwise — conservative, but
    an avoidable distortion)."""

    def __init__(self, name: str, objective: float, *,
                 histogram, threshold: float, description: str = ""):
        super().__init__(name, objective, description)
        self.histogram = histogram
        self.threshold = float(threshold)

    def counts(self, values):
        total = self.histogram.count
        if total == 0:
            return None
        return float(self.histogram.count_le(self.threshold)), float(total)


class BurnRateTracker:
    """Windowed burn rates over cumulative ``(t, good, total)``
    samples.

    ``observe`` records one sample (monotonic seconds); retention is
    bounded in BOTH dimensions — trimmed to ``horizon_s`` at the old
    end, and **decimated** at the new end: a sample arriving within
    ``min_interval_s`` of the previous one *replaces* it (cumulative
    counts make the newest value strictly more informative), so a
    per-iteration evaluation cadence against a multi-hour window
    cannot grow the deque past ``~horizon_s / min_interval_s``
    entries.  :meth:`burn_rate` anchors at the newest sample old
    enough to cover the window (or the oldest available) and returns
    ``bad_delta / total_delta / error_budget`` — ``None`` when the
    data spans less than ``min_coverage`` of the window, when no
    events arrived in it, or when fewer than two samples exist.
    """

    def __init__(self, objective: float, horizon_s: float, *,
                 min_coverage: float = 0.5,
                 min_interval_s: Optional[float] = None):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1): {objective}")
        self.objective = float(objective)
        self.horizon_s = float(horizon_s)
        self.min_coverage = float(min_coverage)
        self.min_interval_s = float(
            min_interval_s if min_interval_s is not None
            else horizon_s / 4096.0
        )
        self._samples: Deque[Tuple[float, float, float]] = (
            collections.deque()
        )

    def observe(self, good: float, total: float, t: float) -> None:
        sample = (float(t), float(good), float(total))
        if (
            len(self._samples) >= 2
            and t - self._samples[-2][0] < self.min_interval_s
        ):
            # decimate: the previous sample is closer than the floor to
            # the one before it — supersede it (never the FIRST sample:
            # it anchors cold-start coverage)
            self._samples[-1] = sample
        else:
            self._samples.append(sample)
        cutoff = t - self.horizon_s
        # keep one sample at/just before the horizon: it anchors the
        # full-length window
        while len(self._samples) > 2 and self._samples[1][0] <= cutoff:
            self._samples.popleft()

    @property
    def samples(self) -> List[Tuple[float, float, float]]:
        return list(self._samples)

    def burn_rate(self, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        if len(self._samples) < 2:
            return None
        t1, good1, total1 = self._samples[-1]
        now = t1 if now is None else float(now)
        cutoff = now - float(window_s)
        anchor = self._samples[0]
        for s in self._samples:
            if s[0] <= cutoff:
                anchor = s
            else:
                break
        t0, good0, total0 = anchor
        span = t1 - t0
        if span <= 0 or span < self.min_coverage * float(window_s):
            return None
        d_total = total1 - total0
        if d_total <= 0:
            return None
        d_bad = d_total - (good1 - good0)
        error_rate = max(0.0, d_bad / d_total)
        return error_rate / (1.0 - self.objective)


class SLORule(Rule):
    """Watchdog rule: evaluate one SLO's burn against its windows.

    On each check it samples the SLO's cumulative counts (registry
    counters via ``wd.registry.values()`` — or ``values_fn`` for
    drills/tests — latency SLOs from their bound histogram), records
    them on the tracker, and fires the FIRST window whose short AND
    long burns both exceed its factor.  The emitted
    :class:`HealthEvent` carries the short-window burn as its value,
    the window's factor as its threshold, and a message naming the
    SLO, both windows, and the error budget — then rides the normal
    Watchdog emission fan-out (board / sinks / flight / spans /
    ``on_unhealthy``).
    """

    def __init__(self, slo: SLO, windows: Iterable[Window] = DEFAULT_WINDOWS,
                 *, cooldown: int = 64, values_fn=None,
                 clock=time.monotonic):
        super().__init__(cooldown)
        self.slo = slo
        self.windows = tuple(windows)
        if not self.windows:
            raise ValueError("SLORule needs at least one window")
        for w in self.windows:
            if w.short_s >= w.long_s:
                raise ValueError(
                    f"window short_s must be < long_s: {w}"
                )
        self.name = f"slo_{slo.name}"
        self.values_fn = values_fn
        self._clock = clock
        horizon = max(w.long_s for w in self.windows)
        # sample-count bound: per-iteration checks against multi-hour
        # windows must not hoard samples — keep ≥8 per short window
        self.tracker = BurnRateTracker(
            slo.objective, horizon,
            min_interval_s=min(w.short_s for w in self.windows) / 8.0,
        )

    def _values(self, wd) -> Mapping[str, float]:
        if self.values_fn is not None:
            return self.values_fn()
        reg = getattr(wd, "registry", None)
        return reg.values() if reg is not None else {}

    def evaluate(self, wd, step) -> List[HealthEvent]:
        counts = self.slo.counts(self._values(wd))
        if counts is None:
            return []
        now = self._clock()
        self.tracker.observe(counts[0], counts[1], now)
        for w in self.windows:
            short = self.tracker.burn_rate(w.short_s, now)
            if short is None or short < w.factor:
                continue
            long = self.tracker.burn_rate(w.long_s, now)
            if long is None or long < w.factor:
                continue
            budget = self.slo.error_budget
            return [HealthEvent(
                self.name, w.severity, int(step), float(short),
                float(w.factor),
                f"SLO {self.slo.name!r} (objective "
                f"{self.slo.objective:.4g}, budget {budget:.4g}) "
                f"burning {short:.1f}x over {w.short_s:.0f}s AND "
                f"{long:.1f}x over {w.long_s:.0f}s "
                f"(page factor {w.factor:g})",
            )]
        return []


def serve_slo_rules(
    *,
    ttft_histogram=None,
    ttft_threshold_ms: Optional[float] = None,
    ttft_objective: float = 0.9,
    goodput_objective: float = 0.95,
    deadline_shed_objective: float = 0.99,
    windows: Iterable[Window] = DEFAULT_WINDOWS,
    cooldown: int = 64,
    clock=time.monotonic,
) -> List[SLORule]:
    """The serving SLO set (``docs/serving.md``):

    - ``ttft`` — fraction of admitted requests whose TTFT lands at or
      under ``ttft_threshold_ms`` (needs the scheduler's
      ``ttft_hist``; skipped when either piece is missing);
    - ``goodput`` — completed / (completed + shed) requests;
    - ``deadline_shed`` — requests NOT shed for a blown queue deadline
      (``serve/shed_deadline``) — operationally distinct from goodput:
      this one means demand is exceeding the latency budget, not just
      capacity.
    """
    rules: List[SLORule] = []
    if ttft_histogram is not None and ttft_threshold_ms is not None:
        rules.append(SLORule(
            LatencySLO(
                "ttft", ttft_objective, histogram=ttft_histogram,
                threshold=ttft_threshold_ms,
                description="TTFT under the serving deadline",
            ),
            windows, cooldown=cooldown, clock=clock,
        ))
    rules.append(SLORule(
        CounterRatioSLO(
            "goodput", goodput_objective,
            good_keys=("serve/completed",),
            total_keys=("serve/completed", "serve/shed"),
            description="requests completed vs offered",
        ),
        windows, cooldown=cooldown, clock=clock,
    ))
    rules.append(SLORule(
        CounterRatioSLO(
            "deadline_shed", deadline_shed_objective,
            good_keys=("serve/completed", "serve/shed_growth_victim",
                       "serve/shed_pool_exhausted", "serve/shed_oversize"),
            total_keys=("serve/completed", "serve/shed"),
            description="requests not shed for a blown TTFT deadline",
        ),
        windows, cooldown=cooldown, clock=clock,
    ))
    return rules


#: the TERMINAL shed ledger keys — every ``serve/shed_<reason>``
#: counter EXCEPT ``rerouted``, which is a hop (the request continues
#: on another replica), not an outcome.  Deliberately a literal:
#: ``tests/test_fleetctl.py`` pins it against
#: ``apex_tpu_torch.serve.scheduler.SHED_REASONS`` so a new shed reason
#: cannot silently leak out of (or into) the fleet SLO denominators.
FLEET_TERMINAL_SHED_KEYS = (
    "serve/shed_deadline",
    "serve/shed_growth_victim",
    "serve/shed_pool_exhausted",
    "serve/shed_oversize",
    "serve/shed_poisoned",
    "serve/shed_queue_full",
    "serve/shed_retries_exhausted",
    "serve/shed_draining",
)


def fleet_slo_rules(
    *,
    ttft_histogram=None,
    ttft_threshold_ms: Optional[float] = None,
    ttft_objective: float = 0.9,
    goodput_objective: float = 0.95,
    deploy_loss_objective: float = 0.999,
    windows: Iterable[Window] = DEFAULT_WINDOWS,
    cooldown: int = 64,
    values_fn=None,
    clock=time.monotonic,
) -> List[SLORule]:
    """The FLEET-level SLO set (docs/serving.md "Fleet operations"),
    evaluated over counters aggregated ACROSS replicas (``values_fn``
    is typically ``Fleet.aggregate_values`` — per-replica registries
    fetched and their ``serve/*`` counters summed).

    The per-replica ``serve_slo_rules`` denominators use the rolled-up
    ``serve/shed`` counter; at fleet level that would be a LIE — a
    re-routed request appears as ``shed(rerouted)`` on its source
    replica while completing on its destination, so the fleet rules
    sum the terminal reasons explicitly
    (:data:`FLEET_TERMINAL_SHED_KEYS`):

    - ``fleet_ttft`` — end-to-end TTFT (original ``submitted_at``
      preserved across re-routes) under threshold, from the fleet-wide
      histogram when one is supplied;
    - ``fleet_goodput`` — completed vs terminally resolved across the
      whole fleet, through any churn;
    - ``fleet_deploy_loss`` — requests NOT terminally shed as
      ``draining``: a zero-downtime rolling update must keep this
      budget untouched (drains re-route; only a handoff-less or
      refused drain sheds ``draining``).
    """
    rules: List[SLORule] = []
    if ttft_histogram is not None and ttft_threshold_ms is not None:
        rules.append(SLORule(
            LatencySLO(
                "fleet_ttft", ttft_objective, histogram=ttft_histogram,
                threshold=ttft_threshold_ms,
                description="end-to-end TTFT across the fleet",
            ),
            windows, cooldown=cooldown, values_fn=values_fn, clock=clock,
        ))
    total_keys = ("serve/completed",) + FLEET_TERMINAL_SHED_KEYS
    rules.append(SLORule(
        CounterRatioSLO(
            "fleet_goodput", goodput_objective,
            good_keys=("serve/completed",),
            total_keys=total_keys,
            description="fleet requests completed vs terminally "
                        "resolved (re-routes are hops, not outcomes)",
        ),
        windows, cooldown=cooldown, values_fn=values_fn, clock=clock,
    ))
    rules.append(SLORule(
        CounterRatioSLO(
            "fleet_deploy_loss", deploy_loss_objective,
            good_keys=("serve/completed",) + tuple(
                k for k in FLEET_TERMINAL_SHED_KEYS
                if k != "serve/shed_draining"
            ),
            total_keys=total_keys,
            description="requests not lost to a drain (rolling "
                        "updates must re-route, not shed)",
        ),
        windows, cooldown=cooldown, values_fn=values_fn, clock=clock,
    ))
    return rules


def burn_rate_drill() -> int:
    """The canonical burn-rate fixture: a 50%-error-rate storm against
    a 90% objective (burn 5x) sampled every 60s for six minutes,
    judged by a single (60s, 240s, 2x) window.  The short window is
    covered at the second sample and the long window at half coverage
    by t=120s — exactly ONE alert fires (the cooldown holds the rest).

    Deterministic by construction (synthetic clock, fixed counts):
    the reference's ``bench.py --config serve`` emits the fired count as the
    ``slo_alerts_fired`` row, so the burn-rate path's behavior is
    pinned into the bench_diff golden stream and can never regress
    silently; ``tests/test_slo.py`` asserts the same number against
    the hand-checked math.
    """
    t = {"now": 0.0}
    counts = {"good": 0.0, "total": 0.0}
    rule = SLORule(
        CounterRatioSLO(
            "drill", 0.9, good_keys=("good",), total_keys=("total",)
        ),
        windows=(Window(60.0, 240.0, 2.0, "critical"),),
        values_fn=lambda: dict(counts),
        clock=lambda: t["now"],
    )

    class _Wd:  # the minimal Watchdog surface a rule touches
        registry = None

    fired: List[HealthEvent] = []
    for minute in range(7):
        t["now"] = 60.0 * minute
        fired.extend(rule.check(_Wd(), minute))
        counts["good"] += 50.0
        counts["total"] += 100.0
    return len(fired)
