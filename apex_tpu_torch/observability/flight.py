"""Flight recorder — crash forensics for training runs.

Counterpart of ``apex_tpu/observability/flight.py``, host code copied
over.  :class:`FlightRecorder` is a bounded ring of the last
``capacity`` steps' host-side telemetry (fetched metrics, skip flags)
and an event log (rollbacks, resumes, retries, preemption, checkpoints,
health events), dumped atomically (tmp + ``os.replace``) to
``flight_<ts>.json`` when a run ends badly.  Non-finite values are
written as the strings ``"NaN"`` / ``"Infinity"`` (:func:`json_safe`).

Armed explicitly (``run_resilient(flight=...)``) or by the environment:
``APEX_TPU_FLIGHT=N[:DIR]`` arms one inside any ``run_resilient`` loop.
Recording copies the registry's cached values and never touches the
device; the dump drains the registry first
(:meth:`MetricRegistry.close`, which never raises), so its last frame is
the state at death.  The default directory is ``apex_tpu_flight`` under
the temporary directory (``$TMPDIR``).
"""

from __future__ import annotations

import collections
import json
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "ENV_FLIGHT",
    "DEFAULT_FLIGHT_DIR",
    "DEFAULT_CAPACITY",
    "parse_flight_spec",
    "json_safe",
    "FlightRecorder",
]

ENV_FLIGHT = "APEX_TPU_FLIGHT"
DEFAULT_FLIGHT_DIR = os.path.join(tempfile.gettempdir(), "apex_tpu_flight")
DEFAULT_CAPACITY = 64


def parse_flight_spec(spec: str) -> Tuple[int, Optional[str]]:
    """``(capacity, dir_override)`` from an ``APEX_TPU_FLIGHT`` value.

    Accepted: ``"N"`` (ring of N steps) optionally followed by
    ``:DIR``; ``"0"`` means disabled (callers treat it as unarmed).
    """
    spec = spec.strip()
    dir_override = None
    if ":" in spec:
        head, dir_override = spec.split(":", 1)
        spec, dir_override = head.strip(), dir_override.strip()
    try:
        capacity = int(spec)
    except ValueError:
        raise ValueError(
            f"bad {ENV_FLIGHT} spec {spec!r}; want 'N' or 'N:DIR'"
        )
    if capacity < 0:
        raise ValueError(f"flight capacity must be >= 0, got {capacity}")
    return capacity, dir_override


def json_safe(value):
    """Make ``value`` JSON-serializable without destroying forensics:
    non-finite floats become the strings ``"NaN"`` / ``"Infinity"`` /
    ``"-Infinity"`` (a NaN loss IS the evidence — ``null`` would erase
    it, a bare NaN token is invalid JSON).  The ONE non-finite encoding
    shared by every observability artifact: flight dumps, span dumps
    (:mod:`~apex_tpu_torch.observability.spans`) and the serving chaos
    drill's JSON."""
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "Infinity" if value > 0 else "-Infinity"
        return value
    if isinstance(value, dict):
        return {str(k): json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(v) for v in value]
    if isinstance(value, (str, int, bool)) or value is None:
        return value
    try:
        return json_safe(float(value))
    except Exception:
        return repr(value)


class FlightRecorder:
    """Ring buffer of recent telemetry + event log, dumped on failure.

    Implements the ``run_resilient`` observer protocol (``on_step`` /
    ``on_rollback`` / ``on_resume`` / ``on_preempt`` / ``on_retry``),
    so arming it is just adding it to the observer fan-out — the runner
    does that automatically when ``flight=`` is given or
    ``APEX_TPU_FLIGHT`` is set.

    ``registry`` / ``meter`` / ``goodput`` enrich frames and the dump;
    attach them late via :meth:`attach` when the recorder is created
    before the training program (the env-armed path).
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        directory: Optional[str] = None,
        *,
        registry=None,
        meter=None,
        goodput=None,
        include_board: bool = True,
        run: Optional[Mapping[str, Any]] = None,
        _clock=time.time,
    ):
        if capacity < 1:
            raise ValueError("flight capacity must be >= 1")
        self.capacity = int(capacity)
        self.directory = directory or os.environ.get(
            ENV_FLIGHT + "_DIR", DEFAULT_FLIGHT_DIR
        )
        self.registry = registry
        self.meter = meter
        self.goodput = goodput
        self.include_board = include_board
        self.run = dict(run or {})
        self._clock = _clock
        self._frames: collections.deque = collections.deque(maxlen=capacity)
        # events are rarer than frames but must survive longer — a
        # rollback 200 steps ago still explains a dump; bound anyway
        self._events: collections.deque = collections.deque(
            maxlen=max(4 * capacity, 256)
        )
        self._seq = 0
        self._prev_step: Optional[int] = None
        self.dumps: List[str] = []

    @classmethod
    def from_env(cls, spec: Optional[str] = None, **kwargs):
        """A recorder armed by ``APEX_TPU_FLIGHT=N[:DIR]``, or ``None``
        when the env is unset/empty/``0`` (the unarmed no-op path)."""
        spec = spec if spec is not None else os.environ.get(ENV_FLIGHT)
        if not spec:
            return None
        capacity, dir_override = parse_flight_spec(spec)
        if capacity == 0:
            return None
        if dir_override:
            kwargs["directory"] = dir_override
        return cls(capacity, **kwargs)

    def attach(self, *, registry=None, meter=None, goodput=None) -> None:
        """Late-bind telemetry sources (env-armed recorders exist before
        the training program does)."""
        if registry is not None:
            self.registry = registry
        if meter is not None:
            self.meter = meter
        if goodput is not None:
            self.goodput = goodput

    # -- recording ---------------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq - 1

    def on_step(self, step: int, skipped: bool = False, info=None) -> None:
        """Record one step frame — host-side dict copies only, never a
        device sync (the registry's cached values may be a cadence
        stale; :meth:`dump` drains the fresh ones)."""
        step = int(step)
        frame: Dict[str, Any] = {
            "seq": self._next_seq(),
            "step": step,
            "t": self._clock(),
            "skipped": bool(skipped),
        }
        if self._prev_step is not None and step <= self._prev_step:
            # a rollback replay rewound the counter: keep recording —
            # both passes are evidence — but mark the frame so the
            # timeline renders the rewind instead of hiding it
            frame["replay"] = True
        self._prev_step = step
        if self.registry is not None:
            frame["metrics"] = self.registry.values()
            frame["fetched_step"] = self.registry.fetched_step
        if self.meter is not None:
            frame["step_time_ms"] = self.meter.step_time * 1e3
        self._frames.append(frame)

    def note(self, kind: str, **data) -> None:
        """Append an event (rollback, retry, health, ...) to the log."""
        self._events.append(
            {"seq": self._next_seq(), "t": self._clock(), "kind": kind,
             **data}
        )

    # observer protocol (events)
    def on_rollback(
        self, step: int, anchor: int, skips: int = 0,
        discarded: Optional[int] = None,
    ) -> None:
        self.note(
            "rollback", step=int(step), anchor=int(anchor),
            skips=int(skips),
            discarded=None if discarded is None else int(discarded),
        )
        # the replay restarts below the anchor; reset the rewind marker
        # baseline so the FIRST replayed frame carries the replay mark
        # relative to the pre-rollback position (kept as-is: on_step
        # compares against the real previous step)

    def on_resume(self, step: int) -> None:
        self.note("resume", step=int(step))

    def on_preempt(self, step: int) -> None:
        self.note("preempt", step=int(step))

    def on_retry(self, what: str = "", attempt: int = 0, error=None) -> None:
        self.note(
            "retry", what=str(what), attempt=int(attempt),
            error=None if error is None else f"{type(error).__name__}: {error}",
        )

    def on_checkpoint(self, step, info=None) -> None:
        """A checkpoint event — the enqueue (``info=None``) or a
        completed async-engine phase (``info`` = the engine's event
        record: write/finalize timings, ok flag).  A postmortem wants
        these next to the step frames: "did the state at death ever
        reach disk" is the first question."""
        data = dict(info) if info else {"phase": "enqueue"}
        data.pop("step", None)
        self.note(
            "checkpoint", step=-1 if step is None else int(step), **data
        )

    def note_health(self, event) -> None:
        """Record a :class:`apex_tpu_torch.observability.health.HealthEvent`."""
        self.note(
            "health", rule=event.rule, severity=event.severity,
            step=int(event.step), value=event.value,
            threshold=event.threshold, message=event.message,
            host=event.host,
        )

    # -- introspection -----------------------------------------------------
    @property
    def frames(self) -> List[Dict[str, Any]]:
        return list(self._frames)

    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    # -- the dump ----------------------------------------------------------
    def dump(self, reason: str, directory: Optional[str] = None) -> str:
        """Write the black box to ``flight_<ts>.json`` atomically
        (tmp + ``os.replace`` — a reader never sees a torn file) and
        return the path.

        Drains the registry's async buffers first via
        :meth:`MetricRegistry.close` (best-effort — a poisoned device
        buffer must not lose the dump) and appends a ``final`` frame
        with the freshest values, so the last state the dump shows is
        the state at death, not one fetch cadence earlier.
        """
        final: Dict[str, Any] = {"t": self._clock()}
        if self.registry is not None:
            final["metrics"] = self.registry.close()
            final["fetched_step"] = self.registry.fetched_step
        if self.meter is not None:
            final["meter"] = self.meter.summary()
        from apex_tpu_torch.parallel import multihost

        host = {"id": multihost.host_id(), "count": multihost.host_count()}
        # the per-process monotonic→epoch anchor (captured once in
        # observability.spans): lines this dump up against span
        # records from the same or other processes
        try:
            from apex_tpu_torch.observability.spans import wall_clock_anchor

            anchor = wall_clock_anchor()
        except Exception:
            anchor = None
        payload: Dict[str, Any] = {
            "version": 1,
            "reason": str(reason),
            "wall_time": self._clock(),
            "anchor": anchor,
            "host": host,
            "capacity": self.capacity,
            "run": self.run,
            "frames": self.frames,
            "final": final,
            "events": self.events,
        }
        if self.goodput is not None:
            payload["goodput"] = self.goodput.snapshot()
        if self.include_board:
            from apex_tpu_torch.observability.metrics import board

            payload["board"] = board.snapshot()
        directory = directory or self.directory
        os.makedirs(directory, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(
            directory, f"flight_{ts}_{os.getpid()}_{self._seq}.json"
        )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(json_safe(payload), f, indent=1, allow_nan=False)
            f.write("\n")
        os.replace(tmp, path)
        self.dumps.append(path)
        return path
