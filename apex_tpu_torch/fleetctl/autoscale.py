"""Burn-rate-driven autoscaling for the replica fleet.

Counterpart of ``apex_tpu/fleetctl/autoscale.py``, host code copied over.

The :class:`Autoscaler` turns the SLO machinery into a capacity
controller: on an evaluation cadence it samples the FLEET-WIDE TTFT
SLI (every live replica's ``ttft_hist`` folded into one cumulative
good/total pair — observations at or under ``ttft_threshold_ms`` are
good) into a :class:`~apex_tpu_torch.observability.slo.BurnRateTracker`, and

- **scales OUT** on a fast burn — the short-window burn rate at or
  over ``out_factor`` means the fleet is eating its TTFT error budget
  faster than sustainable NOW — or on raw queue pressure (mean live
  depth at or over ``queue_high``: a traffic spike shows up in queue
  depth before the TTFTs it will blow are even measurable);
- **scales IN** on sustained headroom — ``headroom_evals``
  consecutive evaluations with mean depth at or under ``queue_low``
  and no burn signal, and only above ``min_replicas``;
- is **cooldown-bounded** (``cooldown_ticks`` between decisions) so a
  single storm cannot flap the fleet.

The autoscaler only DECIDES; the :class:`~apex_tpu_torch.fleetctl.fleet.
Fleet` executes (spawn / drain-and-retire) and stamps every executed
decision as a ``fleet_scale_out`` / ``fleet_scale_in``
:class:`~apex_tpu_torch.observability.health.HealthEvent` on the shared
span timeline — a capacity change is a health-relevant act and must
be visible next to the request chains it affected.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from apex_tpu_torch.observability.health import HealthEvent
from apex_tpu_torch.observability.slo import BurnRateTracker

__all__ = ["AutoscalerConfig", "Autoscaler"]

SCALE_OUT = "out"
SCALE_IN = "in"


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Scaling policy knobs (see the module docstring)."""

    min_replicas: int = 1
    max_replicas: int = 6
    #: a TTFT at or under this is a good event for the burn-rate SLI
    ttft_threshold_ms: float = 100.0
    #: the SLI objective (fraction of TTFTs under threshold)
    objective: float = 0.9
    #: burn-rate windows (seconds, on the fleet clock)
    short_window_s: float = 0.5
    long_window_s: float = 4.0
    #: short-window burn at/over this pages a scale-out
    out_factor: float = 3.0
    #: mean live-replica depth (queued+running) at/over this is spike
    #: pressure — scale out without waiting for TTFTs to complete
    queue_high: float = 8.0
    #: mean depth at/under this counts toward headroom
    queue_low: float = 1.0
    #: consecutive headroom evaluations before a scale-in
    headroom_evals: int = 3
    #: minimum fleet ticks between two executed decisions
    cooldown_ticks: int = 16
    #: evaluate every N fleet ticks
    eval_every: int = 4

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )


class Autoscaler:
    """Decide ``"out"`` / ``"in"`` / ``None`` per evaluation tick."""

    def __init__(self, config: Optional[AutoscalerConfig] = None, *,
                 clock=None):
        self.config = config or AutoscalerConfig()
        c = self.config
        self.clock = clock
        self.tracker = BurnRateTracker(
            c.objective, c.long_window_s,
            min_interval_s=c.short_window_s / 8.0,
        )
        self._headroom = 0
        self._last_decision_tick: Optional[int] = None
        #: every decision this scaler made, in order (the drill's
        #: ">=1 out AND >=1 in" acceptance reads it)
        self.decisions: List[HealthEvent] = []

    # -- signals -----------------------------------------------------------
    def fleet_sli(self, replicas: Iterable) -> Tuple[float, float]:
        """Cumulative fleet ``(good, total)`` TTFT events: every live
        replica's histogram folded together.  Dead replicas drop out —
        their history must not keep diluting (or inflating) the burn
        after they stopped taking traffic."""
        good = total = 0.0
        for rep in replicas:
            hist = rep.sched.ttft_hist
            total += float(hist.count)
            good += float(hist.count_le(self.config.ttft_threshold_ms))
        return good, total

    def _in_cooldown(self, tick: int) -> bool:
        return (
            self._last_decision_tick is not None
            and tick - self._last_decision_tick < self.config.cooldown_ticks
        )

    # -- the decision ------------------------------------------------------
    def evaluate(self, live_replicas: List, tick: int) -> Optional[
        HealthEvent
    ]:
        """One evaluation: sample the SLI, judge burn + queue
        pressure, return the decision as a ``fleet_scale_out`` /
        ``fleet_scale_in`` :class:`HealthEvent` (or ``None``).  The
        tracker SAMPLES every call even in cooldown — a cooldown mutes
        the actuator, not the measurement."""
        c = self.config
        if tick % c.eval_every != 0 or not live_replicas:
            return None
        now = self.clock() if self.clock is not None else float(tick)
        good, total = self.fleet_sli(live_replicas)
        if total > 0:
            self.tracker.observe(good, total, now)
        burn = self.tracker.burn_rate(c.short_window_s, now)
        depth = (
            sum(r.depth for r in live_replicas) / len(live_replicas)
        )

        n = len(live_replicas)
        event: Optional[HealthEvent] = None
        burning = burn is not None and burn >= c.out_factor
        if burning or depth >= c.queue_high:
            self._headroom = 0
            if n < c.max_replicas and not self._in_cooldown(tick):
                value, threshold = (
                    (burn, c.out_factor) if burning
                    else (depth, c.queue_high)
                )
                event = HealthEvent(
                    "fleet_scale_out", "warn", int(tick), float(value),
                    float(threshold),
                    f"scale out {n} -> {n + 1}: "
                    + (f"TTFT burn {burn:.1f}x over "
                       f"{c.short_window_s:g}s (page factor "
                       f"{c.out_factor:g})" if burning
                       else f"mean queue depth {depth:.1f} >= "
                            f"{c.queue_high:g}"),
                )
        elif depth <= c.queue_low and (burn is None or burn < 1.0):
            self._headroom += 1
            if (
                self._headroom >= c.headroom_evals
                and n > c.min_replicas
                and not self._in_cooldown(tick)
            ):
                event = HealthEvent(
                    "fleet_scale_in", "info", int(tick), float(depth),
                    float(c.queue_low),
                    f"scale in {n} -> {n - 1}: mean depth "
                    f"{depth:.2f} <= {c.queue_low:g} for "
                    f"{self._headroom} evaluations, burn "
                    f"{'n/a' if burn is None else f'{burn:.2f}x'}",
                )
        else:
            self._headroom = 0

        if event is not None:
            self._last_decision_tick = tick
            self._headroom = 0
            self.decisions.append(event)
        return event
