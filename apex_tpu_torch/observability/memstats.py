"""Live device-memory telemetry — the runtime half of the memory story.

Counterpart of ``apex_tpu/observability/memstats.py``.  The static
estimate (:mod:`apex_tpu_torch.analysis.memory`) predicts a peak for each
recorded program, and the serving engine gates its build on it; this
module holds the prediction against what the caching allocator really
holds:

- :class:`DeviceMemoryProvider` reads ``torch.cuda.memory_stats`` of each
  visible card (``allocated_bytes.all.current`` and ``.peak``, and the
  card's total memory as the limit).  On a machine with no card it
  raises, unless asked for the empty view (``allow_empty=True``); the
  CPU tests use :class:`FakeMemoryProvider`, scripted or seeded from the
  estimates themselves.
- :class:`MemStatsMonitor` samples the provider, publishes the
  watermark gauges (``memstats/<dev>/bytes_in_use``,
  ``peak_bytes_in_use``, ``bytes_limit``) and keeps a bounded history.
- :meth:`MemStatsMonitor.crosscheck` reconciles the live peak against
  the estimates on the board (``serve/hbm/<program>/peak_hbm_bytes``
  from the engine build, ``analysis/peak_hbm_bytes`` from the graph
  lint): drift past the tolerance in EITHER direction is a finding
  naming the program whose estimate governs.  The expectation is the
  largest program estimate (the programs share the weights and the pool
  on one card), and the tolerance is loose: the estimate is a model.
- :class:`MemStatsRule` runs sample and crosscheck inside the
  :class:`~apex_tpu_torch.observability.health.Watchdog`.
- :func:`oom_forensics` / :meth:`MemStatsMonitor.on_allocation_failure`:
  when an allocation fails (``torch.cuda.OutOfMemoryError``), the
  watermark history drains into the flight recorder as an ``oom`` event
  before the exception propagates.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time
from typing import Any, Deque, Dict, List, Mapping, Optional

__all__ = [
    "DeviceMemoryProvider",
    "FakeMemoryProvider",
    "default_provider",
    "static_peaks_from_board",
    "MemStatsMonitor",
    "MemStatsRule",
    "oom_forensics",
]

#: the stat keys a provider reports per device (floats, bytes)
STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

_STATIC_PEAK_RE = re.compile(r"^serve/hbm/(?P<program>.+)/peak_hbm_bytes$")


class DeviceMemoryProvider:
    """``torch.cuda.memory_stats`` across the visible cards.

    ``stats()`` returns ``{"device<i>": {bytes_in_use,
    peak_bytes_in_use, bytes_limit}}`` from the caching allocator
    (``allocated_bytes.all.current`` and ``.peak``) and the card's total
    memory.  With no card it raises, unless ``allow_empty`` asks for the
    empty view (callers then fall back to a :class:`FakeMemoryProvider`
    or record nothing).
    """

    kind = "device"

    def __init__(self, *, allow_empty: bool = False):
        import torch

        if not torch.cuda.is_available() and not allow_empty:
            raise RuntimeError(
                "DeviceMemoryProvider reads the cards' allocators and no "
                "CUDA device is available; pass allow_empty=True for an "
                "empty view, or use FakeMemoryProvider")
        self.allow_empty = allow_empty

    def stats(self) -> Dict[str, Dict[str, float]]:
        import torch

        out: Dict[str, Dict[str, float]] = {}
        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            in_use = float(ms.get("allocated_bytes.all.current", 0.0))
            out[f"device{i}"] = {
                "bytes_in_use": in_use,
                "peak_bytes_in_use": float(
                    ms.get("allocated_bytes.all.peak", in_use)),
                "bytes_limit": float(
                    torch.cuda.get_device_properties(i).total_memory),
            }
        return out

    @property
    def available(self) -> bool:
        return bool(self.stats())


class FakeMemoryProvider:
    """Scripted provider for the CPU tests and planted-drift checks.

    >>> fake = FakeMemoryProvider(limit_bytes=1 << 30)
    >>> fake.set_usage(bytes_in_use=100 << 20)       # peak tracks max
    >>> fake.stats()["device0"]["peak_bytes_in_use"]
    104857600.0
    """

    kind = "fake"

    def __init__(self, devices: int = 1, limit_bytes: float = 0.0):
        if devices < 1:
            raise ValueError("need at least one fake device")
        self._stats = {
            f"device{i}": {
                "bytes_in_use": 0.0,
                "peak_bytes_in_use": 0.0,
                "bytes_limit": float(limit_bytes),
            }
            for i in range(devices)
        }

    @classmethod
    def from_static(cls, static_peaks: Mapping[str, float], *,
                    scale: float = 1.0, limit_factor: float = 4.0,
                    devices: int = 1) -> "FakeMemoryProvider":
        """A fake whose live peak is ``scale`` x the largest static
        prediction — ``scale=1.0`` reconciles cleanly, ``scale=2.0``
        is the planted drift the CI gate must flag."""
        if not static_peaks:
            raise ValueError("from_static needs at least one static peak")
        peak = float(max(static_peaks.values())) * float(scale)
        fake = cls(devices=devices,
                   limit_bytes=max(peak, 1.0) * float(limit_factor))
        for i in range(devices):
            fake.set_usage(device=i, bytes_in_use=peak)
        return fake

    def set_usage(self, *, device: int = 0, bytes_in_use: float,
                  peak: Optional[float] = None) -> None:
        s = self._stats[f"device{device}"]
        s["bytes_in_use"] = float(bytes_in_use)
        s["peak_bytes_in_use"] = float(
            peak if peak is not None
            else max(s["peak_bytes_in_use"], bytes_in_use)
        )

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {dev: dict(s) for dev, s in self._stats.items()}

    @property
    def available(self) -> bool:
        return True


def default_provider() -> Optional[DeviceMemoryProvider]:
    """The real provider when a card is present, else ``None`` (the
    CPU) — callers pick their fake explicitly."""
    p = DeviceMemoryProvider(allow_empty=True)
    return p if p.available else None


def static_peaks_from_board(board=None) -> Dict[str, float]:
    """Harvest the static peak-HBM predictions already published to the
    board: one entry per serve step program
    (``serve/hbm/<program>/peak_hbm_bytes`` — the engine build), plus
    the graph linter's whole-step ``analysis/peak_hbm_bytes`` under the
    program name ``"analysis"``."""
    if board is None:
        from apex_tpu_torch.observability.metrics import board as board_

        board = board_
    out: Dict[str, float] = {}
    for key, value in board.snapshot().items():
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        m = _STATIC_PEAK_RE.match(key)
        if m:
            out[m.group("program")] = float(value)
        elif key == "analysis/peak_hbm_bytes":
            out["analysis"] = float(value)
    return out


class MemStatsMonitor:
    """Sample a provider, publish watermark gauges, keep history,
    reconcile against the static analyzer.

    ``sample()`` is host-side and cheap (one ``memory_stats()`` call
    per device, dict copies); run it on the observation cadence or
    hand it to an :class:`~apex_tpu_torch.observability.ometrics.OpsServer`
    as its ``collect`` hook so every scrape carries fresh watermarks.
    """

    def __init__(self, provider, *, history: int = 256,
                 prefix: str = "memstats", clock=time.monotonic):
        if provider is None:
            raise ValueError(
                "MemStatsMonitor needs a provider — use "
                "default_provider() and fall back to a "
                "FakeMemoryProvider on CPU"
            )
        self.provider = provider
        self.prefix = prefix
        self._clock = clock
        self._history: Deque[Dict[str, Any]] = collections.deque(
            maxlen=history
        )
        self.samples = 0

    # -- sampling ---------------------------------------------------------
    def sample(self, step: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        from apex_tpu_torch.observability.metrics import board

        stats = self.provider.stats()
        frame: Dict[str, Any] = {"t": self._clock(), "devices": stats}
        if step is not None:
            frame["step"] = int(step)
        self._history.append(frame)
        self.samples += 1
        for dev, s in stats.items():
            for key in STAT_KEYS:
                board.set(f"{self.prefix}/{dev}/{key}", s[key])
        board.set(f"{self.prefix}/samples", self.samples)
        return stats

    def watermarks(self) -> List[Dict[str, Any]]:
        """The watermark history (oldest first) — what the OOM hook
        drains into the flight recorder."""
        return [dict(f) for f in self._history]

    def live_peaks(self) -> Dict[str, float]:
        """Per-device high-water mark over the recorded history."""
        peaks: Dict[str, float] = {}
        for frame in self._history:
            for dev, s in frame["devices"].items():
                peaks[dev] = max(
                    peaks.get(dev, 0.0), s["peak_bytes_in_use"]
                )
        return peaks

    # -- the static-vs-live reconciliation --------------------------------
    def crosscheck(self, static_peaks: Optional[Mapping[str, float]] = None,
                   *, tolerance: float = 0.25) -> List[Dict[str, Any]]:
        """Reconcile live watermarks against static predictions.

        Returns drift findings (empty = reconciled).  The expected live
        peak is the MAX over program predictions; a device whose
        watermark exceeds it by more than ``tolerance`` means the
        analyzer **under**-predicted (the dangerous direction: the
        budget gate is lying), a watermark under it by more than
        ``tolerance`` means it **over**-predicted (the estimate drifted
        from the program actually running).  Either way the finding
        names the governing program.  With no static predictions or no
        samples the result is ``[]`` and ``memstats/crosscheck`` on
        the board says ``-1`` ("no basis") — distinguishable from a
        clean ``0``.
        """
        from apex_tpu_torch.observability.metrics import board

        static = dict(
            static_peaks if static_peaks is not None
            else static_peaks_from_board()
        )
        live = self.live_peaks()
        if not static or not live:
            board.set(f"{self.prefix}/crosscheck", -1.0)
            return []
        program, expected = max(static.items(), key=lambda kv: kv[1])
        findings: List[Dict[str, Any]] = []
        worst = 1.0
        for dev, peak in sorted(live.items()):
            if expected <= 0:
                continue
            ratio = peak / expected
            if abs(ratio - 1.0) > max(abs(worst - 1.0), 0.0):
                worst = ratio
            if ratio > 1.0 + tolerance:
                direction = "static-under-predicts"
            elif ratio < 1.0 - tolerance:
                direction = "static-over-predicts"
            else:
                continue
            mib = 1 << 20
            findings.append({
                "rule": "memstats-drift",
                "device": dev,
                "program": program,
                "live_peak_bytes": int(peak),
                "static_peak_bytes": int(expected),
                "ratio": ratio,
                "direction": direction,
                "tolerance": tolerance,
                "message": (
                    f"{dev} live HBM watermark {peak / mib:.1f} MiB vs "
                    f"static peak {expected / mib:.1f} MiB for program "
                    f"{program!r} ({ratio:.2f}x, tolerance "
                    f"±{tolerance:.0%}) — {direction}"
                ),
            })
        board.set(f"{self.prefix}/crosscheck", float(len(findings)))
        board.set(f"{self.prefix}/crosscheck_ratio", worst)
        return findings

    # -- OOM forensics -----------------------------------------------------
    def on_allocation_failure(self, error=None, *, flight=None,
                              spans=None) -> Dict[str, Any]:
        """Drain the watermark history for the black box.  Safe to call
        from an exception handler: records to the flight recorder's
        event log (``kind="oom"``), the span recorder's health track,
        and the board — none of which touch the device — and returns
        the payload for callers without either recorder."""
        from apex_tpu_torch.observability.metrics import board

        payload: Dict[str, Any] = {
            "error": None if error is None
            else f"{type(error).__name__}: {error}",
            "live_peaks": self.live_peaks(),
            "watermarks": self.watermarks(),
            "provider": getattr(self.provider, "kind", "?"),
        }
        board.set(f"{self.prefix}/oom", 1.0)
        if flight is not None:
            flight.note("oom", **payload)
        if spans is not None:
            spans.instant(
                "health/oom", spans.now(), track="health",
                error=payload["error"],
                live_peaks=payload["live_peaks"],
            )
        return payload


def _looks_like_oom(error: BaseException) -> bool:
    if isinstance(error, MemoryError):
        return True
    try:
        import torch

        if isinstance(error, torch.cuda.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    text = f"{type(error).__name__}: {error}"
    return (
        "RESOURCE_EXHAUSTED" in text
        or "Out of memory" in text
        or "out of memory" in text
    )


@contextlib.contextmanager
def oom_forensics(monitor: MemStatsMonitor, *, flight=None, spans=None):
    """Wrap an allocation-prone region: an OOM-shaped exception
    (``torch.cuda.OutOfMemoryError``, ``RESOURCE_EXHAUSTED``,
    ``MemoryError``) takes one final
    watermark sample and drains the history into the flight recorder
    before re-raising — every other exception passes through
    untouched."""
    try:
        yield monitor
    except BaseException as e:
        if _looks_like_oom(e):
            try:
                monitor.sample()
            except Exception:
                pass  # the provider may be the thing that is dying
            monitor.on_allocation_failure(e, flight=flight, spans=spans)
        raise


class MemStatsRule:
    """Watchdog rule: sample + crosscheck on the check cadence.

    Drift findings become :class:`~apex_tpu_torch.observability.health
    .HealthEvent` s (critical past ``2 × tolerance``, warn inside it),
    so they ride the normal emission fan-out — board, sinks, flight
    recorder, span timeline.  Subclassing deferred to composition: the
    health module stays import-light, so this mirrors the
    :class:`~apex_tpu_torch.observability.health.Rule` surface instead of
    importing it at module scope.
    """

    severity = "warn"

    def __init__(self, monitor: MemStatsMonitor, *,
                 static_peaks: Optional[Mapping[str, float]] = None,
                 tolerance: float = 0.25, cooldown: int = 64):
        self.monitor = monitor
        self.static_peaks = static_peaks
        self.tolerance = tolerance
        self.cooldown = cooldown
        self.name = "memstats_drift"
        self._last_fired: Optional[int] = None

    def check(self, wd, step: int) -> List[Any]:
        # the sample must run EVERY check (the watermark history is the
        # OOM forensics record); only the alerting honors the cooldown
        self.monitor.sample(step)
        if (
            self._last_fired is not None
            and step - self._last_fired < self.cooldown
        ):
            return []
        events = self.evaluate(wd, step)
        if events:
            self._last_fired = step
        return events

    def evaluate(self, wd, step: int) -> List[Any]:
        from apex_tpu_torch.observability.health import HealthEvent

        findings = self.monitor.crosscheck(
            self.static_peaks, tolerance=self.tolerance
        )
        events = []
        for f in findings:
            severity = (
                "critical"
                if abs(f["ratio"] - 1.0) > 2 * self.tolerance
                else "warn"
            )
            events.append(HealthEvent(
                self.name, severity, int(step), float(f["ratio"]),
                1.0 + self.tolerance, f["message"],
            ))
        return events
